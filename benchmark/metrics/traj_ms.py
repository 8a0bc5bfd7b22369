"""Device ms a call spends in every kernel that is not ``fused_mel_*`` or
``mfcc_tail_*``: the trajectory stage (the filters, the gradient, the
clip's peak and the masks), read by exclusion."""


def read(view):
    if view.n_calls == 0:
        return None
    rest = [op for op in view.kernels if "fused_mel" not in op.name and "mfcc_tail" not in op.name]
    return sum(op.dur for op in rest) * 1e-3 / view.n_calls
