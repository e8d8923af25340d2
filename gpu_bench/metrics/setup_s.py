"""setup_s: from the start of the process to the window (imports, the
client's keys, the program's key preparation, kernel loads, capture)."""


def read(run):
    return run.setup_s
