"""Process start to the first timed call: imports, libraries, inputs, warm-up."""


def read(run):
    return run.setup_s
