"""CLI: generate RULER task data (equivalent of the reference's
`create_dataset.sh` + `prepare.py` pipeline).

  python -m xkv_tpu_torch.evalharness.ruler.generate \\
      --tasks niah_single_1 vt cwe fwe \\
      --datalen 65536 --num-samples 96 \\
      --tokenizer <hf tokenizer dir or 'none'> \\
      --model-template-type llama-3 --save-dir <dir>

Output layout matches the reference's Dataset loader expectation
(`evaluate/data/dataset.py:238`):
  {save_dir}/{family}/{datalen}/{task}/validation.jsonl
"""

import argparse
import os

from xkv_tpu_torch.evalharness.ruler.generators import generate_task, write_jsonl
from xkv_tpu_torch.evalharness.ruler.tasks import SYNTHETIC_TASKS


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", nargs="+", default=list(SYNTHETIC_TASKS))
    ap.add_argument("--datalen", type=int, default=65536)
    ap.add_argument("--num-samples", type=int, default=96)
    ap.add_argument("--tokenizer", default="none", help="HF tokenizer path or 'none'")
    ap.add_argument("--model-template-type", default="base")
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--qa-json-dir", default=None)
    args = ap.parse_args()

    tokenizer = None
    if args.tokenizer != "none":
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer)

    from xkv_tpu_torch.evalharness.dataset import default_data_dir, tokenizer_family

    save_dir = args.save_dir or default_data_dir()
    family = (
        args.model_template_type
        if args.model_template_type != "base"
        else tokenizer_family(getattr(tokenizer, "name_or_path", "base"))
    )

    for task in args.tasks:
        rows = generate_task(
            task,
            tokenizer=tokenizer,
            max_seq_length=args.datalen,
            num_samples=args.num_samples,
            random_seed=args.seed,
            model_template_type=args.model_template_type,
            qa_json_dir=args.qa_json_dir,
        )
        path = os.path.join(
            save_dir, family, str(args.datalen), task, "validation.jsonl"
        )
        write_jsonl(rows, path)
        print(f"{task}: {len(rows)} samples -> {path}")


if __name__ == "__main__":
    main()
