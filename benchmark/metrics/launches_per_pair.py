"""launches_per_pair: kernels run on the device in the traced window per
pair written (device trace)."""

KINDS = ("Memcpy", "Memset")  # copies and fills are not kernel launches


def read(ctx):
    if not ctx.pairs or not ctx.ops:
        return None
    n = sum(1 for name, _, _ in ctx.ops if not name.startswith(KINDS))
    return n / ctx.pairs
