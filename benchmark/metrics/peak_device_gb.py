"""Peak device memory allocated over set-up and window
(torch.cuda.max_memory_allocated), in GB of 1e9 bytes."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
