"""Driver ``fused``: the fused simulate -> dirty-map round trip, in a closed loop.

Each call hands ``draco_tpu_torch.telescope.roundtrip.fused_simulate_to_map``
a new Gaussian sky of the configuration's band, and with ``weighted`` new
m-mode weights with zero-weight gaps, both drawn on the device from (seed,
call).  Set-up builds the telescope and its ``BeamTransfer`` and makes one
call on inputs of the same shapes, so the window finds every table built
and every kernel loaded (the window's first call is as fast as the rest:
PERF.md, section 6).  A reservoir drawn from the seed keeps the maps of
``check_calls`` calls of the window; after it the float64 reference
recomputes each from the same inputs, and the check compares the maps by
their largest difference over the reference's largest value.
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import inputs
from portbench.window import whole_calls
from portbench.reference.geometry import Telescope
from portbench.reference.roundtrip import RoundTrip

WARMUP_CALL = -1  # call index of the set-up's call: no window call draws it


def program_telescope(config: dict):
    """The program's telescope and ``BeamTransfer`` for a configuration."""
    from draco_tpu_torch import telescope as tmod

    params = {k: v for k, v in config["telescope"].items() if k != "class"}
    tel = getattr(tmod, config["telescope"]["class"])(
        **params, **config["band"], force_lmax=config["lmax"], force_mmax=config["mmax"],
    )
    return tel, tmod.BeamTransfer(tel, nside=config["nside"])


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|, in the reference's precision."""
    got = got.to(want.device, want.dtype)
    return ((got - want).abs().max() / want.abs().max()).item()


def reference_telescope(config: dict) -> Telescope:
    return Telescope(config["telescope"], config["band"], config["nside"], config["lmax"], config["mmax"])


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from draco_tpu_torch.telescope.roundtrip import fused_simulate_to_map

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.fused = fused_simulate_to_map
        self.tel, self.bt = program_telescope(config)
        self.nfreq = self.tel.nfreq
        self.sky_shape = (self.nfreq, self.tel.num_pol_sky, 12 * config["nside"] ** 2)
        self.weight_shape = (config["mmax"] + 1, 2, self.nfreq, len(self.tel.uniquepairs))
        self.slot = inputs.reservoir(seed, traffic["check_calls"])
        self.kept: dict[int, tuple[int, torch.Tensor]] = {}
        self._call(WARMUP_CALL)
        self.sync()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def inputs(self, k: int):
        sky = inputs.sky(self.device, self.seed, k, self.sky_shape)
        if not self.traffic["weighted"]:
            return sky, None
        t = self.traffic
        w = inputs.mmode_weight(self.device, self.seed, k, self.weight_shape, t["weight_low"], t["weight_high"],
                                t["weight_zero_share"], t["weight_zero_rows"])
        return sky, w

    def _call(self, k: int) -> torch.Tensor:
        sky, w = self.inputs(k)
        return self.fused(self.bt, sky, weight=w)

    def step(self, k: int) -> int:
        """Call k of the window, to its end on the device; the channels it carried."""
        out = self._call(k)
        self.sync()
        slot = self.slot(k)
        if slot is not None:
            self.kept[slot] = (k, out)
        return self.nfreq

    def run_window(self, seconds: float, on_start, on_end) -> tuple[int, int, list[float]]:
        """Whole calls until ``seconds`` have passed: (calls, channels, each call's seconds)."""
        return whole_calls(self.step, seconds, on_start, on_end)

    def release(self):
        """Free the program's state; the kept maps go to the host."""
        self.kept = {s: (k, out.cpu()) for s, (k, out) in self.kept.items()}
        self.bt = self.tel = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, dtype=torch.float64, tf32: bool = False) -> RoundTrip:
        """The reference in ``dtype``; TF32 matmuls only where asked for (the control)."""
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = tf32
        refs = self.__dict__.setdefault("_refs", {})
        if dtype not in refs:
            refs[dtype] = RoundTrip(reference_telescope(self.config), dtype, self.device, self.traffic["reference_chunk"])
        return refs[dtype]

    def check(self) -> list[tuple[str, float, float]]:
        """(name, value, limit) of every compared number."""
        ref = self._reference()
        limit = self.traffic["limits"]["map_rel_err"]
        out = []
        for _, (k, got) in sorted(self.kept.items(), key=lambda kv: kv[1][0]):
            out.append((f"map_rel_err.call{k}", rel_err(got, ref(*self.inputs(k))), limit))
        return out

    def reading(self, program: bool) -> dict:
        """The compared number of call 0 of ``self.seed``: the program's, or the
        control's (the reference in float32 with TF32 matmuls in its place)."""
        sky, w = self.inputs(0)
        t0 = time.perf_counter()
        if program:
            got = self.fused(self.bt, sky, weight=w)
        else:
            got = self._reference(torch.float32, tf32=True)(sky, w)
        self.sync()
        t1 = time.perf_counter()
        want = self._reference()(sky, w)
        self.sync()
        key = "program" if program else "control"
        return {f"{key}.map_rel_err": rel_err(got, want), f"{key}_s": t1 - t0,
                "reference_s": time.perf_counter() - t1}
