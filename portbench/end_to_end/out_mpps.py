"""Output megapixels of every frame whose result was in the caller's hands
inside the window, over the window's seconds."""


def read(run):
    return run.win.done * run.out_px / 1e6 / run.win.seconds
