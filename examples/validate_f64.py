"""Non-normal single-precision eigensolve with f64 validation: on a
strongly convective operator, f32
residual-converged Ritz values can sit OUTSIDE the true spectrum while
genuinely meeting their residual bound — the operator's
eps_f32-pseudospectrum.  ``eigs(..., validate='f64')`` re-applies the
converged pairs through a float64 operator, attaches an
:class:`arpack_ng_tpu.F64Validation` report, and warns
(:class:`arpack_ng_tpu.PseudospectrumWarning`) when the result deserves
pseudospectral interpretation.

The reference's snaupd shares the property (residual-bounded
convergence is all any Krylov method can certify); it just never tells
the user.

Run:  python examples/validate_f64.py
"""
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np

import arpack_ng_tpu as at
from arpack_ng_tpu import models


def main():
    _, a_sp = models.convection_diffusion_2d(16, rho=400.0,
                                             dtype=np.float32)
    a32 = a_sp.astype(np.float32)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        vals, vecs, out = at.eigs(a32, k=4, which="LM", ncv=20,
                                  tol=1e-4, maxiter=500,
                                  validate="f64", return_stats=True)
    rep = out.validation
    print(f"converged |lambda|: {np.round(np.abs(vals), 4)}")
    print(f"f64 relative residuals: "
          f"{np.array2string(rep.rel_residuals, precision=2)}")
    print(f"non-normality probe: {rep.nonnormality:.2e}  "
          f"(0 for normal operators)")
    print(f"passed f64 tolerance bar ({rep.tol_bar:.0e}): {rep.passed}")
    for w in caught:
        if issubclass(w.category, at.PseudospectrumWarning):
            print(f"warning raised: {str(w.message)[:100]}...")
            break
    assert rep is not None and np.all(np.isfinite(rep.rel_residuals))
    print("OK")


if __name__ == "__main__":
    main()
