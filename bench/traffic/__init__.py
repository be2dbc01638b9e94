"""Traffic mixes: ``<mix>.json`` holds a generator's ``kind`` and its
parameters, and ``<kind>.py`` in this folder is the generator, with
``make(params, seed, vocab) -> (clients, lead)``: per client the list of
(prompt, reply tokens) it sends in turn, and how many clients start
alone."""

from __future__ import annotations

import importlib
import json
import os

__all__ = ["load", "make"]

HERE = os.path.dirname(os.path.abspath(__file__))


def load(mix: str) -> dict:
    with open(os.path.join(HERE, f"{mix}.json")) as f:
        return json.load(f)


def make(mix: str, seed: int, vocab: int):
    params = load(mix)
    gen = importlib.import_module(f"{__name__}.{params['kind']}")
    return gen.make(params, seed, vocab)
