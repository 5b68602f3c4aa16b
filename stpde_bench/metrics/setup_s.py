"""Set-up: from the process's start to the start of the measured window
(host clock)."""


def read(run):
    return run.rec["setup_s"]
