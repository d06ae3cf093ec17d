"""Process start to the first timed block: imports, the card, the
design, the pool, the kernels' build or load, the bank's compilation and
tables, the warm-up."""


def read(rec):
    return rec.setup_s
