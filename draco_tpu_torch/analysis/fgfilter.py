"""Foreground filtering via SVD/KL mode projection.

Port of ``draco_tpu.analysis.fgfilter`` (reference
``draco/analysis/fgfilter.py``: _ProjectFilterBase:10, SVDModeProject:53,
KLModeProject:145): forward/backward/filter projections between m-modes,
the telescope SVD basis, and the KL basis, on the data's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.task import ContainerTask


def _row_median(w: torch.Tensor) -> torch.Tensor:
    """Median over everything but the first axis, numpy's convention (the
    mean of the two middle values of an even count)."""
    ws = w.reshape(w.shape[0], -1).sort(dim=1).values
    n = ws.shape[1]
    return 0.5 * (ws[:, (n - 1) // 2] + ws[:, n // 2])


class _ProjectFilterBase(ContainerTask):
    """Project data to/from a basis (reference fgfilter.py:10).

    Attributes
    ----------
    mode : 'forward' | 'backward' | 'filter'
    """

    mode = config.enum(["forward", "backward", "filter"], default="forward")

    def process(self, inp):
        if self.mode == "forward":
            return self._forward(inp)
        if self.mode == "backward":
            return self._backward(inp)
        if self.mode == "filter":
            return self._backward(self._forward(inp))
        return None

    def _forward(self, inp):
        pass

    def _backward(self, inp):
        pass


class SVDModeProject(_ProjectFilterBase):
    """Project between raw m-modes and the telescope SVD basis.

    (reference fgfilter.py:53-142): packed SVD modes concatenate each
    frequency's modes.
    """

    def setup(self, bt):
        self.beamtransfer = io.get_beamtransfer(bt)

    def _forward(self, mmodes):
        bt = self.beamtransfer
        bt.generate(device=mmodes.device)
        bt._ensure_svd()
        tel = bt.telescope
        k = bt.svd_len()

        svdmodes = containers.SVDModes(mode=np.arange(tel.nfreq * k), axes_from=mmodes, attrs_from=mmodes)
        # all m at once: one batched einsum instead of the reference's
        # per-m host loop (reference fgfilter.py:85-97)
        svdm = bt.project_telescope_to_svd(mmodes.vis[:])  # [M, f, k]
        nfk = svdm.shape[1] * svdm.shape[2]
        svdmodes.vis[:, :nfk] = svdm.reshape(svdm.shape[0], -1)
        svdmodes.nmode[:] = nfk
        svdmodes.weight[:] = _row_median(mmodes.weight[:])[:, None].expand(svdmodes.weight.shape)
        return svdmodes

    def _backward(self, svdmodes):
        bt = self.beamtransfer
        bt.generate(device=svdmodes.device)
        bt._ensure_svd()
        tel = bt.telescope
        k = bt.svd_len()

        mmodes = containers.MModes(
            freq=containers.make_freq_map(tel.frequencies),
            prod=tel.uniquepairs,
            input=tel.input_index,
            attrs_from=svdmodes,
            axes_from=svdmodes,
        )
        # batched inverse: [M, f, k] -> [M, f, ntel]
        svdm = svdmodes.vis[:][:, : tel.nfreq * k].reshape(-1, tel.nfreq, k)
        tm = bt.project_svd_to_telescope(svdm)
        mmodes.vis[:] = tm.reshape(-1, tel.nfreq, 2, tel.npairs).permute(0, 2, 1, 3)
        mmodes.weight[:] = _row_median(svdmodes.weight[:])[:, None, None, None].expand(mmodes.weight.shape)
        return mmodes


class KLModeProject(_ProjectFilterBase):
    """Project between the SVD and KL bases (reference fgfilter.py:145).

    Attributes
    ----------
    threshold : float
        KL eigenvalue threshold.
    klname : str
        Name of the KL transform in the product manager.
    """

    threshold = config.float_prop(None)
    klname = config.str_prop("kl")

    def setup(self, manager):
        self.product_manager = manager

    def _get_kl(self):
        if self.klname not in self.product_manager.kltransforms:
            raise RuntimeError(
                f"KL basis {self.klname!r} is not defined here (choices "
                f"are {list(self.product_manager.kltransforms.keys())!r})"
            )
        return self.product_manager.kltransforms[self.klname]

    def _project(self, inp, cls, project):
        """``inp`` through ``project`` into a new ``cls`` container; rows past
        each m's input mode count are zeroed first."""
        out_c = cls(mode=np.arange(inp.vis.shape[1]), axes_from=inp, attrs_from=inp)
        vis = inp.vis[:]
        mask = torch.arange(vis.shape[1], device=vis.device)[None, :] < inp.nmode[:][:, None]
        out, nmode = project(vis * mask)
        out_c.vis[:, : out.shape[1]] = out
        out_c.nmode[:] = nmode
        out_c.weight[:] = _row_median(inp.weight[:])[:, None].expand(out_c.weight.shape)
        return out_c

    def _forward(self, svdmodes):
        kl = self._get_kl()
        # all m at once (reference fgfilter.py:190-203 loops on the host)
        return self._project(svdmodes, containers.KLModes, lambda v: kl.project_svd_to_kl(v, threshold=self.threshold))

    def _backward(self, klmodes):
        kl = self._get_kl()

        def project(v):
            out = kl.project_kl_to_svd(v, threshold=self.threshold)
            return out, out.shape[1]

        return self._project(klmodes, containers.SVDModes, project)
