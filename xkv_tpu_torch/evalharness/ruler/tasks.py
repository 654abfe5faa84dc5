"""RULER task definitions — benchmark protocol constants.

A copy of ``xkv_tpu/evalharness/ruler/tasks.py`` kept inside the port.

The per-task prompt templates and answer prefixes are defined by the public
RULER benchmark (NVIDIA); they must match verbatim for scores to be
comparable (reference `evaluate/data/ruler/synthetic/constants.py:24-54`,
`synthetic.yaml:15-119`, `prepare.py:44-53`). They are data, not code.
"""

# Base task templates (RULER protocol).
TASKS = {
    "niah": {
        "tokens_to_generate": 128,
        "template": (
            "Some special magic {type_needle_v} are hidden within the following "
            "text. Make sure to memorize it. I will quiz you about the "
            "{type_needle_v} afterwards.\n{context}\nWhat are all the special magic "
            "{type_needle_v} for {query} mentioned in the provided text?"
        ),
        "answer_prefix": (
            " The special magic {type_needle_v} for {query} mentioned in the "
            "provided text are"
        ),
    },
    "variable_tracking": {
        "tokens_to_generate": 30,
        "template": (
            "Memorize and track the chain(s) of variable assignment hidden in the "
            "following text.\n\n{context}\nQuestion: Find all variables that are "
            "assigned the value {query} in the text above."
        ),
        "answer_prefix": (
            " Answer: According to the chain(s) of variable assignment in the text "
            "above, {num_v} variables are assgined the value {query}, they are: "
        ),
    },
    "common_words_extraction": {
        "tokens_to_generate": 120,
        "template": (
            "Below is a numbered list of words. In these words, some appear more "
            "often than others. Memorize the ones that appear most often.\n"
            "{context}\nQuestion: What are the 10 most common words in the above "
            "list?"
        ),
        "answer_prefix": (
            " Answer: The top 10 words that appear most often in the list are:"
        ),
    },
    "freq_words_extraction": {
        "tokens_to_generate": 50,
        "template": (
            "Read the following coded text and track the frequency of each coded "
            "word. Find the three most frequently appeared coded words. {context}\n"
            "Question: Do not provide any explanation. Please ignore the dots "
            "'....'. What are the three most frequently appeared words in the "
            "above coded text?"
        ),
        "answer_prefix": (
            " Answer: According to the coded text above, the three most frequently "
            "appeared words are:"
        ),
    },
    "qa": {
        "tokens_to_generate": 32,
        "template": (
            "Answer the question based on the given documents. Only give me the "
            "answer and do not output any other words.\n\nThe following are given "
            "documents.\n\n{context}\n\nAnswer the question based on the given "
            "documents. Only give me the answer and do not output any other "
            "words.\n\nQuestion: {query}"
        ),
        "answer_prefix": " Answer:",
    },
}

# The 11 benchmark task instances (reference `synthetic.yaml`).
SYNTHETIC_TASKS = {
    "niah_single_1": {
        "task": "niah",
        "args": dict(type_haystack="repeat", type_needle_k="words",
                     type_needle_v="numbers", num_needle_k=1, num_needle_v=1,
                     num_needle_q=1),
    },
    "niah_single_2": {
        "task": "niah",
        "args": dict(type_haystack="essay", type_needle_k="words",
                     type_needle_v="numbers", num_needle_k=1, num_needle_v=1,
                     num_needle_q=1),
    },
    "niah_single_3": {
        "task": "niah",
        "args": dict(type_haystack="essay", type_needle_k="words",
                     type_needle_v="uuids", num_needle_k=1, num_needle_v=1,
                     num_needle_q=1),
    },
    "niah_multikey_1": {
        "task": "niah",
        "args": dict(type_haystack="essay", type_needle_k="words",
                     type_needle_v="numbers", num_needle_k=4, num_needle_v=1,
                     num_needle_q=1),
    },
    "niah_multikey_2": {
        "task": "niah",
        "args": dict(type_haystack="needle", type_needle_k="words",
                     type_needle_v="numbers", num_needle_k=1, num_needle_v=1,
                     num_needle_q=1),
    },
    "niah_multikey_3": {
        "task": "niah",
        "args": dict(type_haystack="needle", type_needle_k="uuids",
                     type_needle_v="uuids", num_needle_k=1, num_needle_v=1,
                     num_needle_q=1),
    },
    "niah_multivalue": {
        "task": "niah",
        "args": dict(type_haystack="essay", type_needle_k="words",
                     type_needle_v="numbers", num_needle_k=1, num_needle_v=4,
                     num_needle_q=1),
    },
    "niah_multiquery": {
        "task": "niah",
        "args": dict(type_haystack="essay", type_needle_k="words",
                     type_needle_v="numbers", num_needle_k=1, num_needle_v=1,
                     num_needle_q=4),
    },
    "vt": {"task": "variable_tracking", "args": dict(num_chains=1, num_hops=4)},
    "cwe": {
        "task": "common_words_extraction",
        "args": dict(freq_cw=30, freq_ucw=3, num_cw=10),
    },
    "fwe": {"task": "freq_words_extraction", "args": dict(alpha=2.0)},
    "qa_1": {"task": "qa", "args": dict(dataset="squad")},
    "qa_2": {"task": "qa", "args": dict(dataset="hotpotqa")},
}

# Chat-model wrapping templates (reference `prepare.py:44-53`).
MODEL_TEMPLATES = {
    "base": "{task_template}",
    "llama-3": (
        "<|begin_of_text|><|start_header_id|>system<|end_header_id|>You are a "
        "helpful assistant<|eot_id|><|start_header_id|>user<|end_header_id|>"
        "{task_template}<|eot_id|><|start_header_id|>assistant<|end_header_id|>"
    ),
    "qwen": (
        "<|im_start|>system\nYou are a helpful assistant<|im_end|>\n"
        "<|im_start|>user\n{task_template}<|im_end|>\n<|im_start|>assistant\n"
    ),
    "deepseek": "<｜begin▁of▁sentence｜>User: {task_template}\n\nAssistant:",
}


def build_template(task: str, model_template_type: str = "base") -> str:
    """Wrap a task template in the model chat template + answer prefix
    (reference `prepare.py:92-99`)."""
    base = TASKS[task]
    wrapped = MODEL_TEMPLATES[model_template_type].format(
        task_template=base["template"]
    )
    return wrapped + base["answer_prefix"]
