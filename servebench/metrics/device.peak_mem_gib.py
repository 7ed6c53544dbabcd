"""device.peak_mem_gib: torch.cuda.max_memory_allocated() over the run up
to the window's close (the reference runs after), in GiB."""


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2**30
