"""The card's peak of allocated memory over the traced steps, in GiB:
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``."""


def read(state, digest):
    return digest.peak_bytes / 2**30
