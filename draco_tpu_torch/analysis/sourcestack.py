"""Stacking formed beams over catalog sources in frequency offset.

Port of ``draco_tpu.analysis.sourcestack``, which re-provides reference
``draco/analysis/sourcestack.py`` (SourceStack:17, RandomSubset:214,
GroupSourceStacks:332).  Every (source, frequency-channel) contribution is
routed into its offset bin by one segment sum on the formed beams' device,
batched over polarisations, with off-stack pairs parked in a sentinel
segment.  The segment sum is a one-hot matrix product in float64 and not
``index_add_``: on the card ``index_add_`` adds in no fixed order, the
product in a fixed one, so a stack is the same from run to run.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config, containers
from ..core.task import ContainerTask, PipelineStopIteration, RandomTask
from ..ops.tools import invert_no_zero

#: HI hyperfine rest frequency in MHz
NU21 = 1420.405751768

# pairs (rows of the one-hot matrix) a block of the segment sum
_SEGMENT_BLOCK = 1 << 16


def _stack_segments(beam: torch.Tensor, weight: torch.Tensor, seg_ids: torch.Tensor, nstack: int, uniform: bool):
    """Weighted segment sum of beams into offset bins, per polarisation.

    beam, weight : [nsource, npol, nfreq]
    seg_ids : [nsource * nfreq] target bin per pair; ``nstack`` parks
        invalid pairs in a discarded sentinel segment.

    Returns (stack[npol, nstack], weight_sum[npol, nstack]) in float64.
    """
    npol = beam.shape[1]
    beam = beam.to(torch.float64)
    w = (weight > 0).to(torch.float64) if uniform else weight.to(torch.float64)

    # [nsource, npol, nfreq] -> [nsource * nfreq, npol]
    def flat(a):
        return a.permute(0, 2, 1).reshape(-1, npol)

    wb, ww = flat(w * beam), flat(w)
    num = torch.zeros(nstack + 1, npol, dtype=torch.float64, device=beam.device)
    den = torch.zeros_like(num)
    segs = torch.arange(nstack + 1, device=beam.device)
    for r0 in range(0, wb.shape[0], _SEGMENT_BLOCK):
        onehot = (seg_ids[None, r0 : r0 + _SEGMENT_BLOCK] == segs[:, None]).to(torch.float64)
        num += onehot @ wb[r0 : r0 + _SEGMENT_BLOCK]
        den += onehot @ ww[r0 : r0 + _SEGMENT_BLOCK]

    den = den[:nstack].T
    return num[:nstack].T * invert_no_zero(den), den


class SourceStack(ContainerTask):
    """Average formed beams over catalog sources in offset frequency.

    Each source contributes the spectrum around its own 21 cm frequency,
    shifted onto a common offset axis; the result is the weighted mean
    over sources.  The input BeamForm must have collapsed the hour-angle
    axis.  Semantics of reference ``draco/analysis/sourcestack.py:17-211``.

    Attributes
    ----------
    freqside : int
        Channels kept on each side of each source's own channel.
    single_source_bin_index : int
        If set, keep only sources whose redshifted frequency falls in
        this channel of the input.
    uniform_weight : bool
        Weight every unmasked sample equally instead of by inverse
        variance.
    """

    freqside = config.int_prop(50)
    single_source_bin_index = config.int_prop(None)
    uniform_weight = config.bool_prop(False)

    def _offset_axis(self, formed_beam, nfreq):
        """Offset-frequency axis: the central ``2 freqside + 1`` channels of
        the input, re-centred on zero."""
        half = self.freqside
        sel = slice(nfreq // 2 - half, nfreq // 2 + half + 1)
        axis = np.copy(formed_beam.frequency[sel])
        axis["centre"] -= axis["centre"][half]
        return axis

    @staticmethod
    def _bin_edges(axis):
        """Channel edges of the offset axis, in its own channel order."""
        step = 1.0 if axis["centre"][-1] >= axis["centre"][0] else -1.0
        lead = axis["centre"] - step * 0.5 * axis["width"]
        tail = axis["centre"][-1] + step * 0.5 * axis["width"][-1]
        return np.append(lead, tail)

    def process(self, formed_beam):
        """Stack over sources; returns FrequencyStack[ByPol]."""
        freq = np.asarray(formed_beam.freq)
        nfreq = freq.size
        pol = formed_beam.pol
        npol = len(pol)
        nstack = 2 * self.freqside + 1

        axis = self._offset_axis(formed_beam, nfreq)
        edges = self._bin_edges(axis)

        # offset of every channel from every source's redshifted line
        z = np.asarray(formed_beam["redshift"][:]["z"])
        nu_src = NU21 / (1.0 + z)
        offset = freq[np.newaxis, :] - nu_src[:, np.newaxis]

        bins = np.digitize(offset, edges) - 1
        in_range = (bins >= 0) & (bins < nstack)

        keep_source = in_range.any(axis=1)
        if self.single_source_bin_index is not None:
            chan = formed_beam.index_map["freq"][self.single_source_bin_index]
            keep_source &= np.abs(nu_src - chan["centre"]) < 0.5 * chan["width"]
        good = in_range & keep_source[:, np.newaxis]
        self.log.info(f"Stacking {int(keep_source.sum())} of {len(nu_src)} sources.")

        beam = formed_beam.beam[:]
        seg_ids = torch.as_tensor(np.where(good, bins, nstack).ravel(), device=beam.device)
        stacked, wsum = _stack_segments(
            beam, formed_beam.weight[:], seg_ids, nstack=nstack, uniform=bool(self.uniform_weight)
        )

        if npol > 1:
            out = containers.FrequencyStackByPol(freq=axis, pol=pol, attrs_from=formed_beam, device=beam.device)
            out.stack[:] = stacked
            out.weight[:] = wsum
        else:
            out = containers.FrequencyStack(freq=axis, attrs_from=formed_beam, device=beam.device)
            out.stack[:] = stacked[0]
            out.weight[:] = wsum[0]
        return out


class RandomSubset(ContainerTask, RandomTask):
    """Emit ``number`` random fixed-size sub-catalogs of a catalog.

    Semantics of reference ``draco/analysis/sourcestack.py:214-329``; the
    draws come from the task's host numpy generator, as in the JAX package.

    Attributes
    ----------
    number : int
        How many sub-catalogs to draw.
    size : int
        Objects in each draw (without replacement).
    """

    number = config.int_prop()
    size = config.int_prop()

    def __init__(self):
        super().__init__()
        self._drawn = 0

    def setup(self, catalog):
        """Store the parent catalog and derive the output tag pattern."""
        self.catalog = catalog
        stem = catalog.attrs.get("tag")
        self._tag_pattern = (f"{stem}_" if stem else "") + "mock_{:05d}"

    def process(self):
        """Draw the next sub-catalog."""
        if self._drawn >= self.number:
            raise PipelineStopIteration

        objects = self.catalog.index_map["object_id"]
        pick = np.sort(self.rng.choice(len(objects), self.size, replace=False))

        sub = self.catalog.__class__(object_id=objects[pick], attrs_from=self.catalog, axes_from=self.catalog)
        sub.attrs["tag"] = self._tag_pattern.format(self._drawn)

        for name, dset in self.catalog.datasets.items():
            if name not in sub.datasets:
                sub.add_dataset(name)
            arr = dset[:]
            if tuple(dset.attrs["axis"])[0] == "object_id":
                arr = arr[torch.as_tensor(pick, device=arr.device)] if isinstance(arr, torch.Tensor) else arr[pick]
            sub.datasets[name][:] = arr

        self._drawn += 1
        return sub


class GroupSourceStacks(ContainerTask):
    """Concatenate incoming frequency stacks along a new mock axis.

    Semantics of reference ``draco/analysis/sourcestack.py:332-467``.

    Attributes
    ----------
    ngroup : int
        Inputs gathered into each emitted container.
    """

    ngroup = config.int_prop(100)

    _PROMOTE = {
        containers.FrequencyStack: containers.MockFrequencyStack,
        containers.FrequencyStackByPol: containers.MockFrequencyStackByPol,
        containers.MockFrequencyStack: containers.MockFrequencyStack,
        containers.MockFrequencyStackByPol: containers.MockFrequencyStackByPol,
    }

    def setup(self):
        """Start with an empty accumulator."""
        self._pending = []
        self._groups_out = 0

    def process(self, stack):
        """Buffer one stack; flush when ``ngroup`` have arrived."""
        self._pending.append(stack)
        self.log.debug(f"Buffered stack {len(self._pending)}/{self.ngroup}.")
        if len(self._pending) % self.ngroup == 0:
            return self._flush()
        return None

    def process_finish(self):
        """Flush any remainder."""
        if self._pending:
            return self._flush()
        return None

    @staticmethod
    def _group_tag(tag, counter_str):
        """Rewrite mock->group->supergroup in the accumulated tag."""
        parts = tag.split("_")
        for marker, promoted in (("group", "supergroup"), ("mock", "group")):
            if marker in parts:
                at = max(i for i, p in enumerate(parts) if p == marker)
                parts[at] = promoted
                parts[at + 1] = counter_str
                return "_".join(parts)
        return "_".join(parts + ["group", counter_str])

    def _flush(self):
        first = self._pending[0]
        counter_str = f"{self._groups_out:03d}"

        def mock_count(s):
            return len(s.index_map["mock"]) if "mock" in s.index_map else 1

        total = sum(mock_count(s) for s in self._pending)
        self.log.info(f"Emitting group {counter_str} with {total} mock realisations.")

        out = self._PROMOTE[first.__class__](
            mock=np.arange(total, dtype=np.int64), axes_from=first, attrs_from=first
        )
        out.attrs["tag"] = (
            self._group_tag(out.attrs.get("tag", ""), counter_str) if "tag" in out.attrs else f"group_{counter_str}"
        )

        for name in first.datasets:
            if name not in out.datasets:
                out.add_dataset(name)
            pieces = []
            for s in self._pending:
                dset = s.datasets[name]
                arr = dset[:]
                if tuple(dset.attrs["axis"])[0] != "mock":
                    arr = arr[None]
                pieces.append(arr)
            joined = (
                torch.cat([p.to(out.datasets[name][:].device) for p in pieces], dim=0)
                if isinstance(pieces[0], torch.Tensor)
                else np.concatenate(pieces, axis=0)
            )
            out.datasets[name][:] = joined

        self._pending = []
        self._groups_out += 1
        return out
