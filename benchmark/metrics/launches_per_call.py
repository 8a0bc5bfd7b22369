"""Device kernels per call: the kernels the traced window holds over its
calls."""


def read(view):
    if view.n_calls == 0:
        return None
    return len(view.kernels) / view.n_calls
