"""Share of the traced window, in %, in which the device ran no operation
(no kernel, copy or set): the window less the union of the device ops'
intervals."""


def read(view):
    if view.window_us <= 0 or not view.device_ops:
        return None
    return 100.0 * (1.0 - view.busy_us / view.window_us)
