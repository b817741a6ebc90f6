"""The device time of the BVH walk, K5 ``bvh_walk_kernel<0>`` and K6
``bvh_walk_kernel<1>``, in ms a traced pass: the kernels' records summed
over the trace, over the units traced. None where the trace is incomplete
or holds no walk."""

KERNELS = ("bvh_walk_kernel<0>", "bvh_walk_kernel<1>")


def read(state, digest):
    if not digest.complete:
        return None
    records = [digest.kernels[k] for k in KERNELS]
    if sum(n for n, _ in records) == 0:
        return None
    return sum(sec for _, sec in records) * 1e3 / digest.units
