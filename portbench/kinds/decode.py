"""Decode requests in a closed loop: one viewer opening one image after another.

Set-up reads the configuration's committed ``.gipb`` streams into memory,
draws the request sequence from the seed (uniform, with replacement) and a
sampling key per request, and decodes every stream once (the kernels and
the rANS library are built and loaded then).

A request is ``compress.bitstream.decode_bitstream(bytes)``: parse, rANS,
dequantize, then the default binned render (projection, selection, kernel
A), timed from the call to the image synchronised on the card. The window
opens at the first call and closes when the request during which
``--seconds`` ran out returns.

``correct``: the plain reference (``reference/gipb.py``, ``render.py``)
decodes the bytes of a sample of the window's requests again (those with
the ``sample`` smallest keys, and the first request of each group of
streams) and renders them at the stream's cap; the root mean square of the
difference to the program's image is compared, over the pixels the
reference decides (``reference/render.py``: a pixel where a Gaussian's centre
puts sigma within rounding of the ``sigma >= 0`` cliff is left out).
"""

from __future__ import annotations

import heapq
import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from portbench import trace as T
from portbench.cell import Cell, fixture_files
from portbench.reference import counts as C
from portbench.reference import gipb
from portbench.reference import render as R


def reference_image(buf: bytes, device, dtype=torch.float32, tf32: bool = False):
    """(image, the pixels its sigma >= 0 gate leaves to rounding)."""
    g = gipb.decode(buf)
    t = lambda a: torch.as_tensor(a).to(device)
    active = torch.ones(g.xy.shape[0], dtype=torch.bool, device=device)
    return R.render_state(t(g.xy), t(g.cov), t(g.colors), active, g.H, g.W, g.cap, dtype, tf32,
                          ties=True)


def rms(a: torch.Tensor, ref) -> float:
    """Root mean square of ``a - image`` over the pixels the reference
    decides, ``ref`` = (image, undecided pixels)."""
    img, tie = ref
    if a.shape != img.shape:
        return float("inf")
    d = (a.double() - img.double())[~tie]
    return float(torch.sqrt(torch.mean(d ** 2)))


class Inputs(NamedTuple):
    bufs: List[bytes]
    group: List[int]          # the stream's entry in the configuration's ``streams``
    requests: np.ndarray      # stream of each request
    keys: np.ndarray          # sampling key of each request


def make_inputs(cell: Cell, seed: int) -> Inputs:
    """Everything a run feeds the program, from the seed."""
    bufs, group = [], []
    for gi, spec in enumerate(cell.config["streams"]):
        for f in fixture_files(cell, spec):
            bufs.append(f.read_bytes())
            group.append(gi)
    rng = np.random.default_rng(seed)
    drawn = int(cell.traffic["requests_drawn"])
    return Inputs(bufs, group, rng.integers(0, len(bufs), size=drawn), rng.random(drawn))


class Traffic:
    def __init__(self, cell: Cell, seed: int, device: torch.device):
        self.cell, self.dev = cell, device
        self.bufs, self.group, self.requests, self.keys = make_inputs(cell, seed)
        self.sample = int(cell.traffic["sample"])
        self.kept: Dict[int, torch.Tensor] = {}
        self.next = 0
        for b in self.bufs:
            self._decode(b)
        self._sync()

    def _sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _decode(self, buf: bytes) -> torch.Tensor:
        from gaussianimage_plus_tpu_torch.compress.bitstream import decode_bitstream

        img, _ = decode_bitstream(buf, device=self.dev)
        return img

    def window(self, seconds: float, tracer=None) -> dict:
        lat: List[float] = []
        heap: List[tuple] = []        # (-key, request): the sample, largest key on top
        first_of_group: Dict[int, int] = {}
        t0 = time.perf_counter()
        i = 0
        while True:
            buf = self.bufs[self.requests[i]]
            t = time.perf_counter()
            img = self._decode(buf)
            self._sync()
            lat.append(time.perf_counter() - t)
            g = self.group[self.requests[i]]
            keep = g not in first_of_group
            if keep:
                first_of_group[g] = i
            if len(heap) < self.sample:
                heapq.heappush(heap, (-self.keys[i], i))
                keep = True
            elif self.keys[i] < -heap[0][0]:
                _, out = heapq.heapreplace(heap, (-self.keys[i], i))
                keep = True
                if out not in first_of_group.values():
                    del self.kept[out]
            if keep:
                self.kept[i] = img
            i += 1
            if time.perf_counter() - t0 >= seconds or i == len(self.requests):
                break
        elapsed = time.perf_counter() - t0
        self.next = i
        return {"decode_fps": i / elapsed, "decode_p95_ms": T.quantile(lat, 0.95) * 1e3,
                "attempted": i, "failed": 0}

    def check(self) -> List[tuple]:
        worst = 0.0
        for i, img in sorted(self.kept.items()):
            ref = reference_image(self.bufs[self.requests[i]], self.dev)
            worst = max(worst, rms(img, ref))
        return [("rms_gap", worst, self.cell.config["limits"]["rms_gap"])]

    def install(self, tracer) -> None:
        """Spans around the host parse and the render (to a sync)."""
        from gaussianimage_plus_tpu_torch.compress import bitstream

        tracer.wrap(bitstream, "deserialize_bitstream", "parse")
        tracer.wrap(bitstream, "decompress_wo_ec", "render", sync=True)

    def traced(self, tracer) -> dict:
        """After the window: ``profiled_requests`` more requests of the same
        traffic under the profiler, and the counted bound of kernel A's work
        in them."""
        from gaussianimage_plus_tpu_torch import kernels

        n = int(self.cell.traffic["profiled_requests"])
        reqs = [self.requests[(self.next + k) % len(self.requests)] for k in range(n)]
        spans = {k: list(v) for k, v in tracer.spans.items()}
        before = {k.__name__: k.launches for k in kernels.wrappers()}
        with T.profiled() as held:
            tracer.annotate = True
            for r in reqs:
                with tracer.span("decode_bitstream"):
                    self._decode(self.bufs[r])
                    self._sync()
            tracer.annotate = False
        launches = {k.__name__: k.launches - before[k.__name__] for k in kernels.wrappers()}
        tracer.stretch = T.Profile(held.prof)
        per_stream: Dict[int, tuple] = {}
        for r in reqs:
            if r not in per_stream:
                g = gipb.decode(self.bufs[r])
                t = lambda a: torch.as_tensor(a).to(self.dev)
                p = R.project(t(g.xy), t(g.cov), torch.ones(len(g.xy), dtype=torch.bool,
                                                          device=self.dev), g.H, g.W)
                per_stream[r] = C.forward(C.pairs(p, g.H, g.W, g.cap))
        return {"frames": self.next, "spans": spans,
                "stretch": {"profile": tracer.stretch, "frames": n, "launches": launches,
                            "forward": [per_stream[r] for r in reqs]}}

    def device_window(self, tracer) -> T.Profile:
        return tracer.stretch
