"""Device proxy: interception, handle virtualization, log & replay (§3, §4.2).

The proxy decouples a worker's host process from the device:

- ``DeviceProxyServer`` — one per physical device; owns the ``DeviceMemory``
  (so it has full visibility into live buffers) and executes device ops.
  It is (almost) stateless: on migration it is simply restarted and the
  client's replay log rebuilds its state.
- ``DeviceProxyClient`` — one per worker process; intercepts device APIs.
  *Dispatch interceptors* (D_Int) ship the call to the server;
  *semantics-aware interceptors* (SA_Int) add logic: memory allocation,
  collective communication, synchronization (the three HAL categories of
  §3.2), plus host-side file-IO tracking (§3.3).

Handles returned to the worker are VIRTUAL (§4.2.1): the client keeps a
virtual→physical map; state-changing calls are logged; after a restore the
log is replayed against a fresh server and the virtual handles stay valid
while the physical ones change.

This is the executable model of the paper's mechanism; the JAX hot path
(``core/elastic.py``) plays the proxy's role inside the compiled step, and
the checkpoint/migration layers use this model for state management.

A copy of ``repro.core.device_proxy``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.buffers import DeviceMemory

STATE_CHANGING = {"create_stream", "create_event", "create_communicator",
                  "malloc"}


@dataclasses.dataclass
class LogEntry:
    api: str
    args: Tuple
    kwargs: Dict
    virtual_handle: Optional[int]


class DeviceProxyServer:
    """Executes device ops against the simulated device memory."""

    def __init__(self, capacity: int, device_id: int = 0):
        self.device_id = device_id
        # the proxy "hogs the entire GPU memory at startup" (§4.2) — the
        # allocator below owns the whole address space.
        self.memory = DeviceMemory(capacity)
        self._phys_counter = itertools.count(1000)
        self.streams: Dict[int, List] = {}
        self.events: Dict[int, bool] = {}
        self.communicators: Dict[int, Dict] = {}
        self.kernel_launches = 0

    def execute(self, api: str, *args, **kwargs) -> Any:
        return getattr(self, f"_op_{api}")(*args, **kwargs)

    # -- ops -------------------------------------------------------------
    def _op_create_stream(self) -> int:
        h = next(self._phys_counter)
        self.streams[h] = []
        return h

    def _op_create_event(self) -> int:
        h = next(self._phys_counter)
        self.events[h] = False
        return h

    def _op_create_communicator(self, world_size: int, rank: int) -> int:
        h = next(self._phys_counter)
        self.communicators[h] = {"world_size": world_size, "rank": rank, "count": 0}
        return h

    def _op_malloc(self, size: int, stable: bool) -> int:
        return self.memory.alloc(size, stable).addr

    def _op_free(self, addr: int, lazy: bool = False) -> None:
        self.memory.free(addr, lazy=lazy)

    def _op_memcpy_h2d(self, addr: int, data: np.ndarray) -> None:
        self.memory.write(addr, data)

    def _op_memcpy_d2h(self, addr: int) -> np.ndarray:
        return np.array(self.memory.read(addr), copy=True)

    def _op_launch_kernel(self, fn: Callable, in_addrs: Tuple[int, ...],
                          out_addrs: Tuple[int, ...]) -> None:
        self.kernel_launches += 1
        ins = [self.memory.read(a) for a in in_addrs]
        outs = fn(*ins)
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        for addr, out in zip(out_addrs, outs):
            self.memory.write(addr, out)

    def _op_record_event(self, event: int) -> None:
        self.events[event] = True

    def _op_stream_wait_event(self, stream: int, event: int) -> None:
        # device-side sync point — the splicing engine hooks this
        pass


class DeviceProxyClient:
    """Per-worker interception layer with virtual handles + replay log."""

    def __init__(self, server: DeviceProxyServer, rank: int = 0):
        self.server = server
        self.rank = rank
        self._virt_counter = itertools.count(1)
        self.v2p: Dict[int, int] = {}          # virtual -> physical handle/addr
        self.log: List[LogEntry] = []          # state-changing call log (§4.2.1)
        self.written_files: List[str] = []     # host SA_Int on libc IO (§3.3)
        self.sync_hooks: List[Callable] = []   # splicing context-switch hooks
        # domain-specific log compaction: freed allocations drop their malloc
        self._freed_virtuals: set = set()

    # -- D_Int dispatch ----------------------------------------------------
    def call(self, api: str, *args, **kwargs) -> Any:
        """Intercept a device API call (the D_Int path)."""
        # client SA_Int: resolve virtual handles in args
        phys_args = tuple(self.v2p.get(a, a) if isinstance(a, int) else a
                          for a in args)
        if api == "stream_wait_event":
            for hook in self.sync_hooks:
                hook(self)
        result = self.server.execute(api, *phys_args, **kwargs)
        if api in STATE_CHANGING:
            vh = next(self._virt_counter)
            self.v2p[vh] = result
            self.log.append(LogEntry(api, args, kwargs, vh))
            return vh
        if api == "free":
            (vaddr,) = args
            self._freed_virtuals.add(vaddr)
            self.v2p.pop(vaddr, None)
        return result

    # -- host SA_Int: file IO tracking (§3.3) -------------------------------
    def open_file(self, path: str, mode: str) -> None:
        if any(m in mode for m in ("w", "a", "+")):
            if path not in self.written_files:
                self.written_files.append(path)

    # -- checkpoint/restore --------------------------------------------------
    def compact_log(self) -> List[LogEntry]:
        """Domain-specific rule: drop mallocs whose buffer was freed."""
        return [e for e in self.log
                if not (e.api == "malloc" and e.virtual_handle in self._freed_virtuals)]

    def snapshot_device_state(self) -> Dict[int, Dict]:
        """Dump live device buffers keyed by VIRTUAL handle.

        Thanks to the malloc SA_Int the proxy knows exactly which regions
        are in use (§4.2) — only those are dumped.
        """
        out = {}
        for vh, phys in self.v2p.items():
            if phys in self.server.memory.buffers:
                buf = self.server.memory.buffers[phys]
                if buf.data is not None:
                    out[vh] = {"data": np.array(buf.data, copy=True),
                               "stable": buf.stable, "addr": phys}
        return out

    def restore(self, new_server: DeviceProxyServer,
                device_state: Dict[int, Dict]) -> None:
        """Respawn against a fresh server: replay the state-changing log,
        then copy tensors back.  Virtual handles keep their values; the
        physical handles change underneath (§4.2.1)."""
        self.server = new_server
        self.v2p = {}
        for entry in self.compact_log():
            phys = new_server.execute(entry.api, *entry.args, **entry.kwargs)
            self.v2p[entry.virtual_handle] = phys
        # mmap SA_Int guarantees stable buffers map to the same addresses
        for vh, st in device_state.items():
            if vh not in self.v2p:
                continue
            new_server.execute("memcpy_h2d", self.v2p[vh], st["data"])
