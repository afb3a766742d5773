"""fluid.incubate.data_generator, the producer side of the MultiSlot wire
format (a copy of paddle_tpu/fluid/incubate/data_generator/__init__.py).

Users subclass, implement `generate_sample(line)` (and optionally
`generate_batch(samples)`), and run_from_stdin / run_from_memory emit
the "<n> v1 .. vn" slot lines that fluid.dataset's QueueDataset and
InMemoryDataset parse: the ETL half of the train_from_dataset path.  For
the same records it writes the same bytes as the reference.
"""

from __future__ import annotations

import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    """Base: drives generate_sample over lines and formats each
    emitted [(slot_name, values), ...] record via _gen_str."""

    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32
        self._line_limit = None

    def _set_line_limit(self, line_limit):
        if not isinstance(line_limit, int) or line_limit < 1:
            raise ValueError("line_limit must be a positive int")
        self._line_limit = line_limit

    def set_batch(self, batch_size):
        self.batch_size_ = int(batch_size)

    # -- user hooks ---------------------------------------------------
    def generate_sample(self, line):
        """Override: return a no-arg generator yielding
        [(slot_name, values), ...] records for one input line (or for
        line=None in run_from_memory mode)."""
        raise NotImplementedError(
            "generate_sample() must be overridden: return a generator "
            "yielding [(name, values), ...] records")

    def generate_batch(self, samples):
        """Override optionally: batch-level postprocessing.  Default
        re-emits each sample unchanged."""

        def local_iter():
            for s in samples:
                yield s

        return local_iter

    # -- the run loops ------------------------------------------------
    def _emit(self, out, batch):
        for record in self.generate_batch(batch)():
            out.write(self._gen_str(record))

    def _run(self, lines, out):
        batch = []
        for line in lines:
            gen = self.generate_sample(line)
            for record in gen():
                if record is None:
                    continue
                batch.append(record)
                if len(batch) >= self.batch_size_:
                    self._emit(out, batch)
                    batch = []
        if batch:
            self._emit(out, batch)

    def run_from_memory(self, out=None):
        """Emit samples produced with no input line (the reference's
        in-memory mode: generate_sample(None))."""
        self._run([None], out or sys.stdout)

    def run_from_stdin(self, out=None):
        """ETL mode: one generate_sample call per stdin line."""
        lines = sys.stdin
        if self._line_limit is not None:
            import itertools

            lines = itertools.islice(sys.stdin, self._line_limit)
        self._run(lines, out or sys.stdout)

    def _gen_str(self, line):
        raise NotImplementedError(
            "use MultiSlotDataGenerator or MultiSlotStringDataGenerator")


def _check_record(record):
    if not isinstance(record, (list, tuple)):
        raise ValueError(
            "generate_sample must yield a list/tuple of (name, values) "
            f"pairs, got {type(record).__name__}: e.g. "
            "[('words', [1926, 8, 17]), ('label', [1])]")


def _format_record(record):
    """'<len> v1 .. vn' per slot, space-joined, newline-terminated —
    the MultiSlot line fluid/dataset.py parses."""
    parts = []
    for _, elements in record:
        parts.append(str(len(elements)))
        parts.extend(str(e) for e in elements)
    return " ".join(parts) + "\n"


class MultiSlotStringDataGenerator(DataGenerator):
    """Values are already strings; fastest path (reference
    MultiSlotStringDataGenerator): each slot emits
    '<len> v1 .. vn', slots space-joined, newline-terminated."""

    def _gen_str(self, record):
        _check_record(record)
        return _format_record(record)


class MultiSlotDataGenerator(DataGenerator):
    """Typed values (reference MultiSlotDataGenerator): the first
    record fixes each slot's name and type (int -> uint64,
    float -> float); later records must match names, order, and may
    only widen int->float, mirroring the reference's proto_info
    promotion."""

    def _gen_str(self, record):
        _check_record(record)
        if self._proto_info is None:
            # build locally; assign only after the WHOLE record
            # validates, so a mid-record error leaves no partial state
            proto = []
            for name, elements in record:
                if not isinstance(name, str):
                    raise ValueError(
                        f"slot name must be str, got "
                        f"{type(name).__name__}")
                if not elements:
                    raise ValueError(
                        f"slot {name!r} is empty: every slot needs at "
                        "least one value (pad it)")
                tp = "uint64"
                for e in elements:
                    if isinstance(e, float):
                        tp = "float"
                    elif not isinstance(e, int):
                        raise ValueError(
                            f"slot {name!r}: values must be int or "
                            f"float, got {type(e).__name__}")
                proto.append((name, tp))
            self._proto_info = proto
        else:
            if len(record) != len(self._proto_info):
                raise ValueError(
                    f"record has {len(record)} slots; first record "
                    f"fixed {len(self._proto_info)}")
            for i, (name, elements) in enumerate(record):
                fixed_name, fixed_tp = self._proto_info[i]
                if name != fixed_name:
                    raise ValueError(
                        f"slot {i} name {name!r} != fixed "
                        f"{fixed_name!r}")
                if not elements:
                    raise ValueError(
                        f"slot {name!r} is empty: every slot needs at "
                        "least one value (pad it)")
                for e in elements:
                    if isinstance(e, float):
                        if fixed_tp == "uint64":
                            # int slot seen emitting floats: promote
                            self._proto_info[i] = (name, "float")
                            fixed_tp = "float"
                    elif not isinstance(e, int):
                        raise ValueError(
                            f"slot {name!r}: bad value type "
                            f"{type(e).__name__}")
        return _format_record(record)
