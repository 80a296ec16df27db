"""System-sensitivity estimation as einsums on the stream's device.

Port of ``draco_tpu.analysis.sensitivity`` (reference
``draco/analysis/sensitivity.py``: ComputeSystemSensitivity:11-261).
Each polarisation group is a row of a membership matrix, and the
radiometric auto x auto outer product is one
``einsum("pij,fit,fjt->fpt")``.  The stream's [freq, stack, time] weights,
counts and autos stay where they lie and are reduced one frequency at a
time; the JAX package copies them to host numpy first.  The stack
classification (pol labels, EW positions, the redundancy patterns) is
host bookkeeping, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers, io
from ..core.task import ContainerTask
from ..ops import tools
from ..ops.tools import invert_no_zero


def measured_noise(member, scale, cnt_f, weight):
    """Inverse-variance ("measured") noise summed over each pol group.

    member : [npol, nstack] group membership (0/1)
    scale : [nstack] 2 for cross-pairs, 1 for autos
    cnt_f : [nfreq, nstack, ntime] redundancy counts
    weight : [nfreq, nstack, ntime] visibility weights

    Returns (var, counter), each [nfreq, npol, ntime].
    """
    flag = (weight > 0.0).to(cnt_f.dtype)
    contrib = cnt_f * scale[None, :, None] * flag
    var = torch.einsum("ps,fst->fpt", member, contrib * cnt_f * invert_no_zero(weight))
    counter = torch.einsum("ps,fst->fpt", member, contrib)
    return var * invert_no_zero(counter) ** 2, counter


def radiometer_noise(pair_member, nfeed, auto, nint):
    """Radiometric prediction from products of stacked autocorrelations.

    pair_member : [npol, nauto, nauto] pol-group membership of each auto
        pair (already excludes disallowed intracylinder pairs)
    nfeed : [nfreq, nauto, ntime] effective feed counts
    auto : [nfreq, nauto, ntime] real parts of the stacked autos
    nint : [nfreq, 1, ntime] integration samples (dnu * tint * (1 - lost))
    """
    x = nfeed * auto
    rad = torch.einsum("pij,fit,fjt->fpt", pair_member, x, x)
    cnt = torch.einsum("pij,fit,fjt->fpt", pair_member, nfeed, nfeed)
    return rad * invert_no_zero(nint * cnt**2)


class ComputeSystemSensitivity(ContainerTask):
    """Per-(freq, pol, time) noise estimates of stacked visibilities.

    Produces two estimates (reference sensitivity.py:11-261): the
    "measured" noise from the stored inverse-variance weights, and the
    "radiometer" prediction built from the autocorrelations via the
    radiometer equation.  Both are referenced to the real part of a
    polarisation-averaged visibility.

    Attributes
    ----------
    exclude_intracyl : bool
        Drop intracylinder baselines from both estimates.  Requires
        cylinder information to still be present in the stack.
    """

    exclude_intracyl = config.bool_prop(False)

    def setup(self, telescope):
        """Keep the telescope model used to classify inputs."""
        self.telescope = io.get_telescope(telescope)

    def _flag_patterns(self, data, nfreq, ntime):
        """Redundancy counts per stack for every (freq, time) sample.

        Input flags (optionally refined by the gain dataset) rarely
        change sample to sample, so counts are computed once per unique
        flag column and gathered back on the device; returns ``[nstack,
        nfreq_eff, ntime]`` where ``nfreq_eff`` is 1 without per-frequency
        gain flags.
        """
        iflg = data.input_flags[:].cpu().numpy().astype(bool)
        if "gain" in data.datasets:
            # gains exactly equal to one mark absent inputs
            gflg = (data.datasets["gain"][:] != (1.0 + 0.0j)).cpu().numpy()
            cols = (iflg[np.newaxis] & gflg).transpose(1, 0, 2).reshape(iflg.shape[0], nfreq * ntime)
            nfreq_eff = nfreq
        else:
            cols = iflg
            nfreq_eff = 1

        patterns, scatter = np.unique(cols, return_inverse=True, axis=1)
        dev = data.weight[:].device
        cnt = tools.calculate_redundancy(
            torch.as_tensor(patterns.astype(np.float32), device=dev),
            np.asarray(data.prod),
            np.asarray(data.reverse_map["stack"]["stack"]),
            len(data.stack),
        )
        return cnt[:, torch.as_tensor(scatter.ravel(), device=dev)].reshape(-1, nfreq_eff, ntime)

    def _classify_stacks(self, data):
        """Per-stack (input_a, input_b), and per input its pol label and EW position."""
        stack_new, stack_flag = tools.redefine_stack_index_map(
            self.telescope, data.input, data.prod, data.stack, data.reverse_map["stack"]
        )
        nbad = int(np.sum(~stack_flag))
        if nbad:
            self.log.warning(f"{nbad} stacks are flagged out by the telescope model; they still enter the sensitivity sums.")

        pairs = data.prod[stack_new["prod"]]
        flip = stack_new["conjugate"].astype(bool)
        in_a = np.where(flip, pairs["input_b"], pairs["input_a"])
        in_b = np.where(flip, pairs["input_a"], pairs["input_b"])

        tel_index = tools.find_inputs(self.telescope.input_index, data.input, require_match=False)
        # the telescope's properties rebuild their arrays on each access: read them once
        tel_pol, tel_pos = np.asarray(self.telescope.polarisation), self.telescope.feedpositions
        pol_of_input = np.array(["N" if ti is None else tel_pol[ti] for ti in tel_index])
        ew_of_input = np.array([0.0 if ti is None else tel_pos[ti, 0] for ti in tel_index])
        return in_a, in_b, pol_of_input, ew_of_input

    @staticmethod
    def _pol_label(pol_of_input, in_a, in_b):
        """Order-independent two-character pol label per stack."""
        pa, pb = pol_of_input[in_a], pol_of_input[in_b]
        return np.char.add(np.where(pa <= pb, pa, pb), np.where(pa <= pb, pb, pa))

    def process(self, data):
        """Return a SystemSensitivity container for ``data``."""
        nfreq, nstack, ntime = data.vis.shape
        vis, weight = data.vis[:], data.weight[:]
        dev = weight.device

        cnt = self._flag_patterns(data, nfreq, ntime)  # [nstack, nfe, ntime]
        in_a, in_b, pol_of_input, ew_of_input = self._classify_stacks(data)
        stack_pol = self._pol_label(pol_of_input, in_a, in_b)

        if self.exclude_intracyl and not hasattr(self.telescope, "cylinder_width"):
            raise AttributeError(
                "exclude_intracyl requires a telescope with a cylinder_width attribute (the intracylinder "
                "separation threshold); silently assuming 0 would make the measured and radiometric estimates use "
                "different baseline sets."
            )
        half_cyl = 0.5 * getattr(self.telescope, "cylinder_width", 0.0)
        ew_sep = np.abs(ew_of_input[in_a] - ew_of_input[in_b])
        allowed = ew_sep > half_cyl if self.exclude_intracyl else np.ones(nstack, dtype=bool)

        pol_names = [p for p in np.unique(stack_pol) if "N" not in p]
        member = np.stack([(stack_pol == p) & allowed for p in pol_names]).astype(np.float32)

        is_auto = in_a == in_b
        if self.exclude_intracyl and int(is_auto.sum()) == len(pol_names):
            raise ValueError(
                "exclude_intracyl needs per-cylinder autos, but this stack retains only one auto per polarisation: "
                "the cylinder axis has already been collapsed."
            )
        scale = 2.0 - is_auto.astype(np.float32)  # both triangles for cross

        # radiometric prediction's bookkeeping: the autos and the
        # pol-group membership of each (auto_i, auto_j) pair
        auto_idx = np.flatnonzero(is_auto)
        auto_input = in_a[auto_idx]
        auto_pol = pol_of_input[auto_input]
        pi = np.broadcast_arrays(auto_pol[:, None], auto_pol[None, :])
        lbl = np.char.add(np.where(pi[0] <= pi[1], pi[0], pi[1]), np.where(pi[0] <= pi[1], pi[1], pi[0]))
        pair_member = np.stack([lbl == p for p in pol_names]).astype(np.float32)
        if self.exclude_intracyl:
            sep = np.abs(ew_of_input[auto_input][:, None] - ew_of_input[auto_input][None, :])
            pair_member *= (sep >= half_cyl).astype(np.float32)[None]

        tint = np.median(np.abs(np.diff(np.asarray(data.time))))
        fmap = data.index_map["freq"]
        dnu = (np.median(fmap["width"]) if fmap.dtype.names else np.median(np.abs(np.diff(fmap)))) * 1e6
        # a 'frac_lost' dataset (raw-data packet-loss fraction) is honoured
        # when present; the reference reads it from the raw acquisition's
        # flags group, which these containers don't model
        if "frac_lost" in data.datasets:
            frac_lost = data.datasets["frac_lost"][:].to(device=dev, dtype=torch.float32)
        else:
            frac_lost = torch.zeros((nfreq, ntime), dtype=torch.float32, device=dev)
        nint = (float(dnu * tint) * (1.0 - frac_lost.double())).to(torch.float32)[:, None, :]

        f32 = dict(dtype=torch.float32, device=dev)
        member_t, scale_t = torch.as_tensor(member, **f32), torch.as_tensor(scale, **f32)
        pair_t = torch.as_tensor(pair_member, **f32)
        auto_t = torch.as_tensor(auto_idx, device=dev)
        npol = len(pol_names)
        var = torch.empty((nfreq, npol, ntime), **f32)
        counter, radiometer = torch.empty_like(var), torch.empty_like(var)
        nfe = cnt.shape[1]
        for f in range(nfreq):
            cnt_f = cnt[:, f % nfe][None]  # [1, nstack, ntime]
            w = weight[f : f + 1].to(torch.float32)
            var[f : f + 1], counter[f : f + 1] = measured_noise(member_t, scale_t, cnt_f, w)
            auto_w = w.index_select(1, auto_t)
            nfeed = cnt_f.index_select(1, auto_t) * (auto_w > 0.0).to(torch.float32)
            auto_vis = vis[f : f + 1].index_select(1, auto_t).real.to(torch.float32)
            radiometer[f : f + 1] = radiometer_noise(pair_t, nfeed, auto_vis, nint[f : f + 1])

        metrics = containers.SystemSensitivity(pol=np.array(pol_names, dtype="<U2"), axes_from=data, attrs_from=data)
        # sqrt(2): quote the std-dev of the real component given that the
        # sums covered both visibility-matrix triangles
        metrics.radiometer[:] = torch.sqrt(2.0 * radiometer)
        metrics.measured[:] = torch.sqrt(2.0 * var)
        metrics.weight[:] = counter
        metrics.frac_lost[:] = frac_lost
        return metrics
