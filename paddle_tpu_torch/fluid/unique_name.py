"""Unique name generation for graph entities (a copy of
paddle_tpu/fluid/unique_name.py: UniqueNameGenerator, generate, guard,
switch), so that the port's builders name every variable and parameter as
the reference's do."""

from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return f"{self.prefix}{key}_{tmp}"


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


def switch(new_generator: UniqueNameGenerator | None = None) -> UniqueNameGenerator:
    global generator
    old = generator
    generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
