"""Seconds of the program's own set-up in this process, from its set-up
spans (``utils.obs.setup_span``): the package's imports (``setup.import``),
the kernels' library loaded (``setup.library``), the model built
(``setup.model``) and any FIR operator designed (``setup.fir_operator``),
each counted where no other set-up span holds it, so that the order of
the calls does not move the sum, less any nvcc build
(``setup.library.build``). None where the program records no set-up
spans or the window traced no call."""


def read(view):
    from modulation_mfcc_tpu_torch.utils import obs

    spans = getattr(obs, "spans", None)
    if spans is None or view.n_calls == 0:
        return None
    setup = {r.id: r for r in spans() if r.name.startswith("setup.")}
    build = "setup.library.build"
    tops = [r for r in setup.values() if r.parent not in setup]
    counted = [r for r in tops if r.name != build]
    if not counted:
        return None
    built = sum(r.end_ns - r.start_ns for r in setup.values() if r.name == build and r.parent in setup)
    return (sum(r.end_ns - r.start_ns for r in counted) - built) * 1e-9
