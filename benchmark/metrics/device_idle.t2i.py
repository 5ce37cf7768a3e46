"""Share of the profiled sub-window in which no kernel, copy or set ran
on the card.  Layer: device.  Moves image_s."""


def read(r):
    prof = r.profile
    if prof is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
