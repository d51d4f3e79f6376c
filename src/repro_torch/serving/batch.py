"""Rolling mixed-timestep batch state for the continuous scheduler.

A :class:`RollingBatch` owns one *shape bucket*'s row state on the device
— the ``(B_cap, ...)`` buffers that ``core.sampling.sample_ensemble_step``
advances — and the host bookkeeping that maps requests onto rows.  The
buffers are allocated once, at the bucket's fixed capacity; admission,
restore, release and each tick write rows into them in place, so every
tick runs the same shapes whatever requests join or leave.

Row lifecycle (encoded in ``t_idx``):

* ``t_idx == num_steps`` — free or finished.  The step freezes the row
  (its latent passes through, its index stays), so a partly full batch
  runs padded rows but stays exact.
* ``t_idx == 0`` — set at admission with the request's own ``N(0, 1)``
  noise (drawn from its seed, as ``generate`` draws it), zeroed routing
  slots and its conditioning rows.
* ``0 < t_idx < num_steps`` — in flight; one step per tick.

A request occupies ``batch_size`` rows in sample order (not necessarily
adjacent); resolution gathers those rows out, so the result is what a
``generate`` call with the same seed returns.

On an ``("expert", "data")`` mesh (``launch.mesh``) the buffers are
placed as ``launch.sharding.rolling_state_shardings`` says: the latent
and conditioning buffers hold this rank's rows ``[lo, hi)`` of the
"data" split (every row where "data" does not divide the capacity), while
``t_idx``, ``slot_idx``, ``slot_w``, the host mirror and the row map are
whole and the same on every rank.  Resolution and snapshots gather the
latent over "data" (``whole_x``), so every rank sees whole requests.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.sharding import rolling_state_shardings


class RollingBatch:
    """Device row buffers and the host row map of one shape bucket.

    ``membership`` is the admission-time elastic snapshot
    (``ServingEngine._membership``) every request of the bucket shares
    (the bucket key holds the epoch), or ``None`` on a fixed-membership
    engine.  ``mesh`` (a ``launch.mesh.ExpertMesh``) places the buffers
    (see the module docstring).
    """

    def __init__(
        self,
        *,
        capacity: int,
        latent_shape: tuple[int, ...],
        k_slots: int,
        num_steps: int,
        device: torch.device,
        text_tail: tuple[int, ...] | None = None,
        membership: tuple | None = None,
        mesh=None,
    ) -> None:
        self.capacity = capacity
        self.latent_shape = tuple(latent_shape)
        self.num_steps = num_steps
        self.device = device
        self.text_tail = tuple(text_tail) if text_tail is not None else None
        self.membership = membership
        self.mesh = mesh
        #: this rank's rows of the latent and conditioning buffers
        self.lo, self.hi = 0, capacity
        if mesh is not None:
            latent, _ = rolling_state_shardings(
                mesh, (capacity,) + self.latent_shape)
            if latent.spec[0] is not None:
                self.lo, self.hi = mesh.data_range(capacity)
        self.split = (self.lo, self.hi) != (0, capacity)
        local = self.hi - self.lo
        self.x = torch.zeros((local,) + self.latent_shape,
                             dtype=torch.float32, device=device)
        self.t_idx = torch.full((capacity,), num_steps, dtype=torch.int64,
                                device=device)
        #: host mirror of ``t_idx``: every active row advances exactly one
        #: step a step, so completion and the router-skip decision never
        #: read the device buffer back (``advance_host``).
        self.t_host = np.full((capacity,), num_steps, np.int64)
        self.slot_idx = torch.zeros((capacity, k_slots), dtype=torch.int64,
                                    device=device)
        self.slot_w = torch.zeros((capacity, k_slots), dtype=torch.float32,
                                  device=device)
        self.text = (
            torch.zeros((local,) + self.text_tail, dtype=torch.float32,
                        device=device)
            if self.text_tail is not None else None
        )
        #: row -> resident request (or None)
        self.rows: list = [None] * capacity
        #: request.seq -> its rows in sample order
        self._rows_of: dict[int, list[int]] = {}
        #: admission order (seq): resolution and failure handling walk
        #: requests oldest first
        self._order: list[int] = []
        self._by_seq: dict[int, object] = {}

    # -- occupancy ----------------------------------------------------------

    def free_count(self) -> int:
        return sum(r is None for r in self.rows)

    @property
    def num_resident(self) -> int:
        return len(self._order)

    def resident_requests(self) -> list:
        """Resident requests, oldest (lowest seq) first."""
        return [self._by_seq[s] for s in sorted(self._order)]

    def rows_of(self, seq: int) -> list[int]:
        """The rows a resident request occupies, in sample order."""
        return list(self._rows_of[seq])

    # -- admission / release ------------------------------------------------

    def _local(self, rows: list[int]) -> tuple[list[int], torch.Tensor]:
        """Which of a request's ``rows`` this rank holds: their positions
        in the request, and their rows of the local buffers."""
        pick = [j for j, r in enumerate(rows) if self.lo <= r < self.hi]
        return pick, torch.tensor([rows[j] - self.lo for j in pick],
                                  dtype=torch.int64, device=self.device)

    def _put_rows(self, buf: torch.Tensor, rows: list[int], val) -> None:
        """Write a request's ``(batch_size, ...)`` ``val`` into the rows of
        a local buffer that this rank holds."""
        pick, local = self._local(rows)
        if pick:
            buf.index_copy_(0, local, val if len(pick) == len(rows)
                            else val[pick])

    def _place(self, req) -> tuple[list[int], torch.Tensor]:
        free = [i for i, r in enumerate(self.rows) if r is None]
        if len(free) < req.batch_size:
            raise RuntimeError(
                f"bucket has {len(free)} free rows < batch_size "
                f"{req.batch_size} (admission control should gate this)"
            )
        rows = free[: req.batch_size]
        if self.text is not None:
            self._put_rows(self.text, rows,
                           req.text_emb.to(self.device, torch.float32))
        for i in rows:
            self.rows[i] = req
        self._rows_of[req.seq] = rows
        self._order.append(req.seq)
        self._by_seq[req.seq] = req
        return rows, torch.tensor(rows, dtype=torch.int64,
                                  device=self.device)

    def admit(self, req, noise: torch.Tensor) -> list[int]:
        """Place ``req`` into the lowest free rows with its own
        ``(batch_size, *latent)`` initial ``noise``; returns the rows."""
        rows, idx = self._place(req)
        self._put_rows(self.x, rows, noise)
        self.t_idx.index_fill_(0, idx, 0)
        self.slot_idx.index_fill_(0, idx, 0)
        self.slot_w.index_fill_(0, idx, 0.0)
        self.t_host[rows] = 0
        return rows

    def admit_restored(self, req, x, t_idx, slot_idx, slot_w) -> list[int]:
        """Re-admit a request at a journal snapshot's row state: latent,
        step index and routing slots written back exactly, so the step
        resumes the same trajectory (row placement does not matter; the
        conditioning rows come from the request as on first admission)."""
        rows, idx = self._place(req)
        t_np = np.asarray(t_idx, np.int64)

        def put(buf, val, dtype):
            buf.index_copy_(0, idx, torch.as_tensor(
                np.asarray(val)).to(self.device, dtype))

        self._put_rows(self.x, rows, torch.as_tensor(np.asarray(x)).to(
            self.device, torch.float32))
        put(self.t_idx, t_np, torch.int64)
        put(self.slot_idx, slot_idx, torch.int64)
        put(self.slot_w, slot_w, torch.float32)
        self.t_host[rows] = t_np
        return rows

    def whole_x(self) -> torch.Tensor:
        """The whole ``(capacity, *latent)`` latent: the buffer itself, or
        on a "data" split its rows all-gathered over "data" (a collective:
        every rank calls it at the same point)."""
        return self.mesh.data_gather(self.x) if self.split else self.x

    def row_state(self, seq: int, whole: torch.Tensor | None = None
                  ) -> dict:
        """Host copy of one resident request's row state (the journal's
        snapshot payload): a device→host read, paid at the snapshot
        cadence only; ``t`` comes from the host mirror.  ``whole`` is
        ``whole_x()`` where the caller already gathered it."""
        rows = self._rows_of[seq]
        idx = torch.tensor(rows, dtype=torch.int64, device=self.device)
        whole = self.whole_x() if whole is None else whole
        return {
            "x": whole[idx].cpu().numpy(),
            "t": self.t_host[rows].copy(),
            "slot_idx": self.slot_idx[idx].cpu().numpy(),
            "slot_w": self.slot_w[idx].cpu().numpy(),
        }

    def release(self, req, *, finished: bool = False) -> list[int]:
        """Free ``req``'s rows (failure path or after resolution): their
        ``t_idx`` goes back to the sentinel so a failed request's rows
        stop at once; a finished request's rows are there already, so
        only the host bookkeeping runs."""
        rows = self._rows_of.pop(req.seq, [])
        if rows:
            if not finished:
                self.t_idx[rows] = self.num_steps
            self.t_host[rows] = self.num_steps
            for i in rows:
                self.rows[i] = None
        if req.seq in self._order:
            self._order.remove(req.seq)
        self._by_seq.pop(req.seq, None)
        return rows

    # -- advancing and completion -------------------------------------------

    def store_state(self, x, t_idx, slot_idx, slot_w) -> None:
        """Write a tick's advanced row state into the buffers."""
        self.x.copy_(x)
        self.t_idx.copy_(t_idx)
        self.slot_idx.copy_(slot_idx)
        self.slot_w.copy_(slot_w)

    def advance_host(self, steps: int = 1) -> None:
        """Mirror a tick on the host counters: every active row advances
        ``steps`` (the tick's ``steps_per_tick``), clamped at the
        sentinel as the step freezes finished rows mid-tick."""
        self.t_host[:] = advanced(self.t_host, self.num_steps, steps)

    def t_idx_host(self) -> np.ndarray:
        """Device read-back of the per-row step indices.  A test hook (it
        waits for the in-flight step); scheduling runs off ``t_host``."""
        return self.t_idx.cpu().numpy()

    def finished_requests(self) -> list:
        """Resident requests whose every row reached the end of the grid,
        in seq order (read from the host mirror)."""
        return [self._by_seq[seq] for seq in sorted(self._order)
                if all(self.t_host[i] >= self.num_steps
                       for i in self._rows_of[seq])]

    def resolve(self, req, whole: torch.Tensor | None = None
                ) -> torch.Tensor:
        """The finished request's latents (its rows in sample order, a
        copy), its rows freed; ``whole`` as in ``row_state``."""
        rows = self._rows_of[req.seq]
        whole = self.whole_x() if whole is None else whole
        out = whole[torch.tensor(rows, dtype=torch.int64,
                                 device=self.device)]
        self.release(req, finished=True)
        return out


def advanced(t_host: np.ndarray, num_steps: int, steps: int) -> np.ndarray:
    """Host step indices after ``steps`` steps: active rows advance,
    clamped at ``num_steps``; frozen rows stay."""
    active = (t_host >= 0) & (t_host < num_steps)
    return np.where(active, np.minimum(t_host + steps, num_steps), t_host)
