"""Set-up seconds: process start to the start of the measured window
(imports, the kernels loaded or built, weights made on the card, the
warm-up steps or batches)."""


def read(rec):
    return rec["setup_s"]
