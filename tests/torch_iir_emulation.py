"""The walk of the zero-phase IIR filter kernel (``csrc/iir.cu``), written out
in torch for the CPU tests (``test_torch_port_dsp.py``).

Every warp of the kernel is emulated at once: a block is a warp of 32
series (lanes), its shared-memory ring ``slots`` time steps of 32 + 1
elements, time runs in chunks of 32 steps. The emulation follows the
kernel's order of copies and steps:

- forward: chunk c + ``AHEAD`` of the odd extension copied into the ring
  (lane l: step 32c + l of every row of the warp, from its mirrored sample
  index), then chunk c through the cascade, each output to the time-major
  scratch below ``hold = L - slots`` or over its own x in the ring above;
- reverse: the scratch's steps copied back into the slots the pass has
  freed, ``AHEAD`` chunks ahead, each lane its own series; the chunk's
  outputs over their inputs; while the next chunk runs, lane l stores step
  l of every row of the last chunk's y.

A copy is a cp.async: it lands either as it is issued (``late=False``) or
only at the ``cp.async.wait_group`` that guarantees it (``late=True``), so
that a slot overwritten too early or read too early shows. Each entry of
the ring carries a tag (what it holds: the x of step i, the forward output
of step i, the output of step i) that every read checks. The cascade's
arithmetic is ``kernels.iir.sos_filtfilt_plain``'s, operation for
operation, so the emulation must equal it bit for bit.
"""

import torch

LANES = 32
CHUNK = 32
PITCH = LANES + 1
AHEAD = 2  # kAhead
X, FWD, OUT = 0, 1 << 40, 2 << 40  # tag bases: x, forward output, output of step i
# (the kernel's kSlots / kChunk >= kAhead + 2: a chunk's outputs are stored
# while the chunk kAhead + 1 below it is copied back)


class Walk:
    """One launch's warps over ``x (N, T)``."""

    def __init__(self, x, sos, zi, padlen: int, slots: int, late: bool):
        assert slots % CHUNK == 0 and slots >= CHUNK * (AHEAD + 2)
        self.x, self.padlen, self.slots, self.late = x, padlen, slots, late
        self.n, self.t = x.shape
        self.len = self.t + 2 * padlen
        self.hold = self.len - slots
        self.warps = -(-self.n // LANES)
        series = torch.arange(self.warps * LANES).reshape(self.warps, LANES)
        self.valid = series < self.n  # (W, lanes)
        self.series = series[self.valid]
        self.rows = series.clamp(max=self.n - 1)  # each lane's row, clamped past n (2 x[0], 2 x[T-1])
        self.ring = torch.full((self.warps, slots * PITCH), float("nan"), dtype=x.dtype)
        self.tag = torch.full((self.warps, slots * PITCH), -1, dtype=torch.int64)
        self.fwd = torch.full((max(self.hold, 0), self.n), float("nan"), dtype=x.dtype)
        self.y = torch.full_like(x, float("nan"))
        self.groups, self.open = [], []  # committed groups of pending copies, the open one
        self.coef = [row.unbind() for row in sos]
        self.zi = [row.unbind() for row in zi]

    # ---- cp.async ----

    def copy(self, warps, index, values, tags) -> None:
        """``ring[warps, index] = values`` (with their tags), as one lane's
        copies into shared memory."""
        if self.late:
            self.open.append((warps, index, values, tags))
        else:
            self.ring[warps, index] = values
            self.tag[warps, index] = tags

    def commit(self) -> None:
        self.groups.append(self.open)
        self.open = []

    def wait(self, pending: int) -> None:
        """``cp.async.wait_group pending``: every group but the newest
        ``pending`` has landed."""
        while len(self.groups) > pending:
            for warps, index, values, tags in self.groups.pop(0):
                self.ring[warps, index] = values
                self.tag[warps, index] = tags

    # ---- the ring ----

    def entries(self, i: int, lanes=None) -> torch.Tensor:
        """Flat ring indices of step i's slot, one per lane (or ``lanes``)."""
        lanes = torch.arange(LANES) if lanes is None else lanes
        return (i % self.slots) * PITCH + lanes

    def read(self, i: int, tag: int) -> torch.Tensor:
        """Each lane's own entry of step i's slot, its tag checked (valid
        lanes)."""
        at = self.entries(i)
        got = self.tag[:, at]
        assert bool((got[self.valid] == tag + i).all()), f"step {i}: tag {got[self.valid]}"
        return self.ring[:, at]

    def write(self, i: int, values: torch.Tensor, tag: int) -> None:
        at = self.entries(i)
        self.ring[:, at] = values
        self.tag[:, at] = tag + i

    def load_x(self, c: int) -> None:
        """Chunk c of the odd extension: lane l copies step 32c + l of every
        row of its warp below n (its mirrored sample)."""
        for lane in range(LANES):
            i = c * CHUNK + lane
            if i >= self.len:
                continue
            j = i - self.padlen
            src = -j if j < 0 else j if j < self.t else 2 * (self.t - 1) - j
            w, rows = self.valid.nonzero(as_tuple=True)  # the rows past n are not copied
            at = (i % self.slots) * PITCH + rows
            self.copy(w, at, self.x[self.series, src], X + i)

    def load_fwd(self, c: int) -> None:
        """Chunk c of the scratch: each valid lane its own series, the steps
        in [padlen, hold)."""
        for k in range(CHUNK):
            i = c * CHUNK + k
            if self.padlen <= i < self.hold:
                w, lanes = self.valid.nonzero(as_tuple=True)
                at = (i % self.slots) * PITCH + lanes
                self.copy(w, at, self.fwd[i, w * LANES + lanes], FWD + i)

    # ---- the cascade (sos_filtfilt_plain's operations) ----

    def start(self, v: torch.Tensor) -> None:
        self.state = [[a * v, b * v] for a, b in self.zi]

    def step(self, v: torch.Tensor) -> torch.Tensor:
        for (b0, b1, b2, _, a1, a2), z in zip(self.coef, self.state):
            y = b0 * v + z[0]
            z[0] = b1 * v - a1 * y + z[1]
            z[1] = b2 * v - a2 * y
            v = y
        return v

    # ---- the kernel ----

    def run(self) -> torch.Tensor:
        p, t, length = self.padlen, self.t, self.len
        two_first, two_last = 2 * self.x[self.rows, 0], 2 * self.x[self.rows, t - 1]
        chunks = -(-length // CHUNK)
        for c in range(AHEAD):
            if c < chunks:
                self.load_x(c)
            self.commit()
        for c in range(chunks):
            self.wait(AHEAD - 1)
            if c + AHEAD < chunks:
                self.load_x(c + AHEAD)
            self.commit()
            for i in range(c * CHUNK, min(c * CHUNK + CHUNK, length)):
                raw = self.read(i, X)
                ext = two_first - raw if i < p else raw if i < p + t else two_last - raw
                if i == 0:
                    self.start(ext)  # zi * ext[0]
                v = self.step(ext)
                if i >= self.hold:
                    self.write(i, v, FWD)
                else:
                    self.fwd[i, self.series] = v[self.valid]
        self.wait(0)
        self.start(v)
        top, bottom = (length - 1) // CHUNK, p // CHUNK
        for c in range(top, top - AHEAD, -1):
            if c >= bottom:
                self.load_fwd(c)
            self.commit()
        for c in range(top, bottom - 1, -1):
            self.wait(AHEAD - 1)
            # the kernel interleaves these with chunk c's steps; issued first
            # here, the copies back land as early as they can
            if c - AHEAD >= bottom:
                self.load_fwd(c - AHEAD)
            if c < top:
                self.store_y(c + 1)
            for i in range(min(c * CHUNK + CHUNK, length) - 1, max(c * CHUNK, p) - 1, -1):
                out = self.step(self.read(i, FWD))
                if i < p + t:
                    self.write(i, out, OUT)
            self.commit()
        self.store_y(bottom)
        return self.y

    def store_y(self, c: int) -> None:
        """Chunk c's outputs to y: lane l stores step 32c + l of every row."""
        p, t = self.padlen, self.t
        for lane in range(LANES):
            i = c * CHUNK + lane
            if not p <= i < p + t:
                continue
            at = (i % self.slots) * PITCH + torch.arange(LANES)
            tags = self.tag[:, at]
            assert bool((tags[self.valid] == OUT + i).all()), f"y of step {i}"
            self.y[self.series, i - p] = self.ring[:, at][self.valid]
