"""The QAT phase's set-up in the profiled coding job: the program's
``qat.warm_chunk`` (the QAT runner's eager chunk, host time to enqueue) and
``qat.capture`` (its graph's capture, which first waits for the device)
spans under the job's ``qat`` root, summed, ms."""

from portbench import program


def read(trace):
    warm = program.under_last_root("qat", "qat.warm_chunk")
    capture = program.under_last_root("qat", "qat.capture")
    if not warm or not capture:
        return None
    return (program.seconds(warm) + program.seconds(capture)) * 1e3
