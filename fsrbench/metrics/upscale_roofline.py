"""The configuration's floor per output frame (``fsrbench/roofline.py``)
over the device's busy time per frame in the traced stretch, in percent;
on several cards the busy time is summed over them.  None without a trace
or a busy card."""


def read(run):
    if run.trace is None or not run.trace.frames:
        return None
    busy = sum(run.trace.busy_s_by_device().values())
    return 100.0 * run.floor_s * run.trace.frames / busy if busy > 0 else None
