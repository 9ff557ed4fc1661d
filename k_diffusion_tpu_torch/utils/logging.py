"""Append-only CSV metrics logger (counterpart of
k_diffusion_tpu/utils/logging.py)."""

from pathlib import Path


class CSVLogger:
    """Writes ``columns`` as the header of a new file, or appends to an
    existing one; ``write(*values)`` adds a row and flushes."""

    def __init__(self, filename, columns):
        self.filename = Path(filename)
        self.filename.parent.mkdir(parents=True, exist_ok=True)
        self.columns = columns
        if self.filename.exists():
            self.file = open(self.filename, "a")
        else:
            self.file = open(self.filename, "w")
            self.write(*self.columns)

    def write(self, *args):
        print(*args, sep=",", file=self.file, flush=True)

    def close(self):
        self.file.close()
