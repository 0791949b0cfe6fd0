"""K1 (the sorted-NMS kernel) at the training step's 1000 -> 500 against
its roofline, %: the least time of each profiled step's own K1 call
(``portbench/harness.py::nms_bound_s`` on its valid boxes and keep set,
summed) over the profiled time of every ``sorted_nms_kernel`` launch."""

KERNEL = "sorted_nms_kernel"


def read(rec):
    bound = rec.get("k1_bound_s")
    spent = sum(s for name, s in rec.get("kernel_s", {}).items()
                if KERNEL in name)
    if not bound or not spent or not rec.get("steps"):
        return None
    return 100.0 * bound / spent
