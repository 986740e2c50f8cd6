"""The pool tier's tree kernels (`csrc/tree_wave.cu`: #2 backup+descend,
#4 descend, #3 expand+backup) against their roofline: the sampled
launches' least time (frozen byte and operation counts over the H100's
peaks) over the device time of those launches."""


def read(trace):
    least = trace.extras.get("roofline_least_s") or []
    spent = trace.device_s("tree_sample", lambda n: n in (
        "backup_descend_kernel", "expand_backup_kernel") or n.startswith(
        ("backup_descend_kernel(", "expand_backup_kernel(")))
    if not least or spent <= 0:
        return None
    return 100.0 * sum(least) / spent
