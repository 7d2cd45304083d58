"""Host ms a step the Trainer's thread spent blocked on the prefetcher's
next item (the program's ``train.wait_input`` spans), over the
``train.chunk`` spans that ran whole inside the traced window."""
from yardstick import spans


def read(ctx):
    return spans.per_step_ms(ctx, "train.wait_input")
