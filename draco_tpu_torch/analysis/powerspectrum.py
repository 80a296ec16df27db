"""Quadratic power spectrum estimation from KL modes.

Port of ``draco_tpu.analysis.powerspectrum`` (reference
``draco/analysis/powerspectrum.py``, QuadraticPSEstimation:10): per-m q
estimators summed over m on the KL modes' device, then a Fisher unmixing
into band powers on the host (the band matrices are nbands x nbands).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as la

from ..core import config, containers
from ..core.task import ContainerTask


def _unwindowed_mixing(fisher):
    return la.pinv(fisher, rtol=1e-8)


def _uncorrelated_mixing(fisher):
    root = la.cholesky(fisher)
    return la.inv(root) / root.sum(axis=1)[:, np.newaxis]


def _minvar_mixing(fisher):
    # a zero Fisher row means the band is unconstrained: its
    # normalisation is ZERO (passing 1.0 would write the raw
    # q - bias through as a plausible-looking band power)
    rowsum = fisher.sum(axis=1)
    safe = np.where(rowsum == 0, 1.0, rowsum)
    return np.diag(np.where(rowsum == 0, 0.0, 1.0 / safe))


_MIXING = {
    "unwindowed": _unwindowed_mixing,
    "uncorrelated": _uncorrelated_mixing,
    "minimum_variance": _minvar_mixing,
}


class QuadraticPSEstimation(ContainerTask):
    """Estimate a 2D band power spectrum from KLModes.

    (reference powerspectrum.py:10-95)

    Attributes
    ----------
    psname : str
        Name of the power spectrum estimator in the product manager.
    pstype : 'unwindowed' | 'minimum_variance' | 'uncorrelated'
    """

    psname = config.str_prop("ps")
    pstype = config.enum(sorted(_MIXING), default="unwindowed")

    def setup(self, manager):
        self.manager = manager

    def process(self, klmodes):
        if not isinstance(klmodes, containers.KLModes):
            raise ValueError(f"A KLModes container is required here, not {klmodes.__class__!s}")
        estimator = self.manager.psestimators[self.psname]
        estimator.genbands()

        # every m in one streamed pass on the device, which also
        # accumulates the Fisher matrix and the bias
        q = estimator.q_estimator_all(klmodes.vis[:], klmodes.nmode[:]).cpu().numpy()
        fisher, bias = (x.cpu().numpy() for x in estimator.fisher_bias())
        bands = _MIXING[self.pstype](fisher) @ (q - bias)

        out = containers.Powerspectrum2D(
            kperp_edges=estimator.kperp_bands, kpar_edges=estimator.kpar_bands, device=klmodes.device
        )
        npar, nperp = (len(out.index_map[k]) for k in ("kpar", "kperp"))
        # band index runs kpar-major; the container stores [kperp, kpar]
        out.powerspectrum[:] = bands.reshape(npar, nperp).T
        out.C_inv[:] = fisher.reshape(npar, nperp, npar, nperp).transpose(1, 0, 3, 2)
        return out
