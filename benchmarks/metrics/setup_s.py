"""From the start of the process to the moment the window opens: the
solver's build, the kernels' load (and, in a fresh checkout, their build),
the one-segment warm-up, the measured pool's set-up and the stream's ramp."""


def read(ctx):
    return ctx["window"]["setup_s"]
