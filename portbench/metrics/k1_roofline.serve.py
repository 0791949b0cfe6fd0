"""K1 (the sorted-NMS kernel) against its roofline, %: the least time of
the traced requests' NMS calls (their bytes over the HBM rate or their
IoU operations over the float32 rate, counted on the inputs and outputs
the plain reference gives for the same volumes) over the profiled time
of every ``sorted_nms_kernel`` launch."""

KERNEL = "sorted_nms_kernel"


def read(rec):
    bound = rec.get("k1_bound_s")
    spent = sum(s for name, s in rec.get("kernel_s", {}).items()
                if KERNEL in name)
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
