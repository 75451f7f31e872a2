"""Process start to the first timed request."""


def read(run):
    return run.setup_s
