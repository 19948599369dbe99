"""Generated tokens a second: the new tokens of every request the window
completed, over the whole window, from its start to the return of its
last batch."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec.get("batches") else None
