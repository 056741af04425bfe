"""The window over the batch iterations run in it (segments x segment
length), in milliseconds."""


def read(ctx):
    w = ctx["window"]
    return 1e3 * w["wall_s"] / (w["segments"] * w["segment"])
