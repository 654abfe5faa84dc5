"""Word sources for the RULER generators.

A copy of ``xkv_tpu/evalharness/ruler/wordlists.py`` kept inside the port.

The reference uses the ``wonderwords`` package's noun/adjective lists
(reference `synthetic/niah.py:92-96`) and Paul Graham essays downloaded from
the web (`synthetic/json/download_paulgraham_essay.py`). Neither is
available offline here, so:

  * a compact built-in English word list provides nouns/adjectives/verbs —
    task semantics (distinct memorable tokens) are preserved;
  * the essay haystack is a deterministic synthetic "essay" built from
    sentence templates — filler noise with natural-language shape;
  * if the real corpora are present (XKV_WORDLIST_DIR / XKV_ESSAY_JSON env
    vars), they are used instead, matching the reference exactly.
"""

from __future__ import annotations

import json
import os
import random
from typing import List

NOUNS = """time year people way day man thing woman life child world school state family
student group country problem hand part place case week company system program question
work government number night point home water room mother area money story fact month lot
right study book eye job word business issue side kind head house service friend father
power hour game line end member law car city community name president team minute idea
body information back parent face others level office door health person art war history
party result change morning reason research girl guy moment air teacher force education
foot boy age policy process music market sense nation plan college interest death
experience effect use class control care field development role effort rate heart drug
show leader light voice wife whole police mind price report decision son view relationship
town road arm difference value building action model season society tax director
position player record paper space ground form event official matter center couple site
project activity star table need court oil situation cost industry figure street image
phone data picture practice piece land product doctor wall patient worker news test movie
north love support technology""".split()

ADJECTIVES = """good new first last long great little own other old right big high different
small large next early young important few public bad same able local sure free low late
hard major better economic strong possible whole final main social easy black white real
best simple left physical general environmental financial blue democratic dark various
entire close legal religious cold international nice huge popular traditional cultural""".split()

VERBS = """be have do say get make go know take see come think look want give use find
tell ask work seem feel try leave call keep help talk turn start show hear play run move
like live believe hold bring happen write provide sit stand lose pay meet include continue
set learn change lead understand watch follow stop create speak read allow add spend grow
open walk win offer remember love consider appear buy wait serve die send expect build
stay fall cut reach kill remain suggest raise pass sell require report decide pull""".split()

_SENTENCE_TEMPLATES = [
    "The {adj} {noun} will {verb} the {adj2} {noun2}.",
    "A {noun} can {verb} when the {noun2} is {adj}.",
    "Every {adj} {noun} must {verb} a {noun2} before the {noun3}.",
    "People {verb} the {noun} because the {noun2} was {adj}.",
    "In the {noun}, the {adj} {noun2} did {verb} quietly.",
]


def word_list() -> List[str]:
    """Distinct words for cwe/fwe sampling (reference uses wonderwords
    noun+adj+verb union, `common_words_extraction.py:65-69`)."""
    wdir = os.environ.get("XKV_WORDLIST_DIR")
    if wdir:
        words: List[str] = []
        for fname in ("nounlist.txt", "adjectivelist.txt", "verblist.txt"):
            p = os.path.join(wdir, fname)
            if os.path.exists(p):
                words += [w.strip() for w in open(p) if w.strip()]
        if words:
            return sorted(set(words))
    return sorted(set(NOUNS + ADJECTIVES + VERBS))


def key_words() -> List[str]:
    """adj-noun compound keys for niah needles (reference `niah.py:92-97`)."""
    return sorted({f"{adj}-{noun}" for adj in ADJECTIVES for noun in NOUNS})


def essay_words(rng: random.Random, approx_words: int = 300_000) -> List[str]:
    """Essay-like filler haystack as a flat word list.

    Loads the real Paul Graham corpus when XKV_ESSAY_JSON points at the
    reference-format json; otherwise synthesizes deterministic sentences.
    """
    path = os.environ.get("XKV_ESSAY_JSON")
    if path and os.path.exists(path):
        text = json.load(open(path))["text"]
        return " ".join(text.split()).split(" ")
    words: List[str] = []
    while len(words) < approx_words:
        tmpl = rng.choice(_SENTENCE_TEMPLATES)
        sent = tmpl.format(
            adj=rng.choice(ADJECTIVES),
            adj2=rng.choice(ADJECTIVES),
            noun=rng.choice(NOUNS),
            noun2=rng.choice(NOUNS),
            noun3=rng.choice(NOUNS),
            verb=rng.choice(VERBS),
        )
        words.extend(sent.split(" "))
    return words
