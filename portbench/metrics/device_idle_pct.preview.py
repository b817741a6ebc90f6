"""The share of the traced window in which the card ran nothing: one less
the union of its kernel and copy records over the window, in percent."""


def read(state, digest):
    if not digest.complete or digest.window_s <= 0:
        return None
    return 100.0 * (1.0 - digest.busy_s / digest.window_s)
