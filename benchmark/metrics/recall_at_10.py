"""recall@10 of the answers the check kept, against the reference's exact
top-10 (`check.judge`)."""


def read(run):
    return run.numbers["recall"]
