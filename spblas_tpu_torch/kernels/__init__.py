"""Structured plans and the hand-written Hopper kernels they launch
(``csrc/``), selected by ``plans.build_matvec_plan`` and
``plans.build_matmul_plan``.

The names below load lazily from their submodules, as in the JAX
package's ``kernels`` (the BSR kernels live in ``bsr_kernels``, the JAX
package's ``bsr_pallas``).  ``bsr_spgemm`` names the submodule here, never
the function of that name inside it, so that an import of the submodule
gives the module whatever was imported before.
"""

_EXPORTS = {
    "BandPlan": "banded", "PermutedBandPlan": "banded",
    "band_plan_from_diags": "banded", "band_power_iterations": "banded",
    "band_spmm": "banded", "band_spmm_stream": "banded",
    "band_spmv": "banded", "band_spmv_ad": "banded",
    "build_band_plan": "banded", "build_permuted_band_plan": "banded",
    "permuted_band_spmv": "banded",
    "bsr_spmm": "bsr_kernels", "bsr_spmv": "bsr_kernels",
    "BsrSpgemmPlan": "bsr_spgemm",
    "bsr_spgemm_compute": "bsr_spgemm",
    "bsr_spgemm_numeric": "bsr_spgemm",
    "DiaPlan": "dia", "build_dia_plan": "dia", "dia_spmm": "dia",
    "dia_spmv": "dia",
    "EllPlan": "ell", "build_ell_plan": "ell", "ell_spmm": "ell",
    "ell_spmv": "ell",
    "build_matvec_plan": "plans", "plan_spmm": "plans",
    "plan_spmv": "plans",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'spblas_tpu_torch.kernels' has no attribute {name!r}")
    import importlib
    value = getattr(
        importlib.import_module(f"spblas_tpu_torch.kernels.{mod}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
