"""Host ms a step the Trainer's thread spent reading the previous chunk's
losses (the program's ``train.drain`` spans: the one wait on the device a
chunk), over the ``train.chunk`` spans that ran whole inside the traced
window."""
from yardstick import spans


def read(ctx):
    return spans.per_step_ms(ctx, "train.drain")
