"""Data-generator authoring API for PS datasets (a copy of
``paddle_tpu/distributed/fleet/data_generator.py``).

Reference parity: python/paddle/distributed/fleet/data_generator/
data_generator.py — users subclass and implement generate_sample();
run_from_stdin/run_from_files emit the MultiSlot text format the
InMemoryDataset/DataFeed parser consumes ("<n> v1..vn" per slot).
"""
import sys


class DataGenerator:
    def __init__(self):
        self.batch_size_ = 1

    def set_batch(self, batch_size):
        self.batch_size_ = int(batch_size)

    def generate_sample(self, line):
        """User hook: returns an iterator of [(slot_name, [values]), ...]
        per output sample (reference contract)."""
        raise NotImplementedError(
            "implement generate_sample() in your DataGenerator subclass")

    def generate_batch(self, samples):
        def local_iter():
            for s in samples:
                yield s
        return local_iter

    def _format(self, record):
        return self._gen_str(record)

    def _gen_str(self, record):
        raise NotImplementedError

    def _emit(self, lines, write):
        # every sample flows through generate_batch (reference contract:
        # subclasses may batch/reorder/augment there), collected in
        # batch_size_ groups
        buf = []
        for line in lines:
            for record in self.generate_sample(line)():
                buf.append(record)
                if len(buf) >= self.batch_size_:
                    for rec in self.generate_batch(buf)():
                        write(self._format(rec))
                    buf = []
        if buf:
            for rec in self.generate_batch(buf)():
                write(self._format(rec))

    def run_from_stdin(self):
        self._emit(sys.stdin, sys.stdout.write)

    def run_from_files(self, filelist, output):
        def lines():
            for path in filelist:
                with open(path) as f:
                    yield from f
        with open(output, "w") as out:
            self._emit(lines(), out.write)


class MultiSlotDataGenerator(DataGenerator):
    """Reference: MultiSlotDataGenerator._gen_str — '<n> v1 .. vn' per
    slot, space-joined, newline-terminated."""

    def _gen_str(self, record):
        parts = []
        for _, values in record:
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return " ".join(parts) + "\n"


class MultiSlotStringDataGenerator(DataGenerator):
    """Reference: MultiSlotStringDataGenerator — values are emitted
    verbatim (already strings)."""

    def _gen_str(self, record):
        parts = []
        for _, values in record:
            parts.append(str(len(values)))
            parts.extend(values)
        return " ".join(parts) + "\n"
