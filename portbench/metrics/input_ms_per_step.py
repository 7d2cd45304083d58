"""Host ms a step that the loader took to make the window's batches (its
gather; the benchmark's own span around each batch it hands the
Trainer, on the staging thread)."""


def read(ctx):
    if not ctx.get("gathered"):
        return None
    return ctx["gather_s"] / ctx["gathered"] * 1e3
