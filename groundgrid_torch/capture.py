"""A body captured as a CUDA graph and replayed: the port's ``jax.jit``.

:class:`Graph` holds the protocol that every captured step of the port
shares (``pipeline.CapturedStep``, the fleet's vehicle step through it, and
the spatial axis's per-device segments, ``parallel/collectives.py``):

  * the capture runs on a side stream, after ``empty_cache``, and records
    ``seconds`` (the capture's wall time) and ``pool_bytes`` (the memory its
    private pool reserved);
  * the kernels a capture launches are taken off the launch counters
    (``ops.counter_values``) and added back on each replay
    (``ops.add_launches``), so the counters still count per run;
  * a capture that fails raises: nothing falls back to the eager body;
  * on the CPU there is no graph: ``capture`` runs the body once and keeps
    its outputs, and ``replay`` runs it again and copies its outputs into
    them, so the static-buffer rules hold, and are tested, on every device.

The body must have run once eagerly on the card before its capture (the
lazy set-up: kernel builds and attributes, tables, counters, NCCL
communicators); it must run the same ops whatever the inputs hold and read
nothing back to the host. Its outputs are the static buffers every replay
rewrites.
"""

from __future__ import annotations

import time

import torch

from groundgrid_torch import ops


class Graph:
    """One body captured on ``device`` and replayed (see the module)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graph = None
        self.outputs: list | None = None  # the static outputs
        self.launches: tuple = ()  # the capture's launch counts, added per replay
        self.seconds: float | None = None
        self.pool_bytes: int | None = None

    def capture(self, body, result=None) -> list:
        """Capture ``body()`` (a list of tensors) and return its outputs.

        On the card nothing runs: the outputs are the buffers each replay
        writes. On the CPU the outputs are clones of ``result``, the eager
        run's that the caller just made, or else ``body()`` run once."""
        if self.device.type != "cuda":
            self.outputs = list(body()) if result is None else [t.clone() for t in result]
            return self.outputs
        device = self.device
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        before, reserved = ops.counter_values(), torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.graph(graph, stream=torch.cuda.Stream(device)):
            result = list(body())
        torch.cuda.synchronize(device)
        self.seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = tuple(a - b for a, b in zip(ops.counter_values(), before))
        ops.set_counters(before)  # the capture ran nothing
        self.graph, self.outputs = graph, result
        return result

    def replay(self, body) -> None:
        """Run the captured body again: a graph replay on the card (``body``
        unused), ``body()`` with its outputs copied into the static ones on
        the CPU."""
        if self.device.type != "cuda":
            for dst, src in zip(self.outputs, body(), strict=True):
                dst.copy_(src)
            return
        with torch.cuda.device(self.device):
            self.graph.replay()
        ops.add_launches(self.launches)
