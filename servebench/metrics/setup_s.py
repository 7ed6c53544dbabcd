"""setup_s: process start to the window's first second (host clock): the
kernel build when it is not cached, the weights, the KV pool's sizing
prefill, the engine, the decode graph's capture and the traffic warm-up."""


def read(run):
    return run.setup_s
