"""Filters × channels × output samples of every block the window
completed, over the window: from the first block handed to the entry to
the host's sight of the last one complete."""


def read(rec):
    if not rec.calls or rec.window_s <= 0:
        return None
    return rec.work["outputs"] * rec.calls / rec.window_s
