"""Decoded training tokens a second: the ``K`` parts' rows of every
completed step (``K × part_batch × seq``) over the whole window, from
its start to the end of its last step."""


def read(rec):
    return rec["tokens"] / rec["window_s"] if rec.get("steps") else None
