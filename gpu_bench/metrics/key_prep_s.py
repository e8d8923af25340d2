"""key_prep_s: the program's key preparation from the raw cloud key,
host clock, card synchronised on both sides."""


def read(run):
    return run.key_prep_s
