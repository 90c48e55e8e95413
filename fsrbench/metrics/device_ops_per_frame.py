"""Every device operation (kernel, copy, memset) in the traced stretch, per
output frame: what dispatch launches."""


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    return len(run.trace.ops) / run.trace.frames
