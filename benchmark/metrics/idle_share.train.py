"""idle_share.train: the share of the traced window with no operation on the
device, in percent."""

from benchlib.layer_metrics import idle_share


def read(ctx):
    return idle_share(ctx, "train")
