"""Set-up seconds: from the process's start to the end of the warm-up."""


def read(rec):
    return rec['setup_s']
