"""The plain reference of the ARAP solve: the annealed Gauss-Newton schedule
with Jacobi-preconditioned CG, in plain torch over a batch of problems.

The energy is the one the program solves (As-Rigid-As-Possible image
deformation: per pixel a warped position and an angle; masked
4-neighbour regularisers with weight w_reg and fit terms with weight w_fit
on constrained pixels), and the gradient and Jacobi diagonal are a frozen
copy of the port's plain formulas. The product JᵀJ·p inside the CG loop is
written out again: the loop-constant planes of a linearisation are formed
once, and the four neighbours are stacked, so an iteration is a few dozen
elementwise operations whatever the batch. `dtype` sets the precision of
every operand and of the state: float32 as the program computes, or
bfloat16 for the control. Imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

DIRS = ((0, 1), (0, -1), (1, 0), (-1, 0))
W_FIT, W_REG = 100.0, 0.01


def shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """b[..., y, x] = a[..., y+dy, x+dx], zero out of bounds."""
    H, W = a.shape[-2:]
    p = F.pad(a, (1, 1, 1, 1))
    return p[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


@dataclass
class Problems:
    """A batch of B problems on (H, W) planes: mask (B, H, W) 1 = solve
    region; vm (B, 4, H, W) direction masks; fit (B, H, W); src, tgt
    (B, 2, H, W) constraint source and target; grid (B, 2, H, W)."""

    mask: torch.Tensor
    vm: torch.Tensor
    fit: torch.Tensor
    src: torch.Tensor
    tgt: torch.Tensor
    grid: torch.Tensor


def build(masks: list, cons: list, H: int, W: int, device,
          dtype=torch.float32) -> Problems:
    """Problems from ARAP masks (h, w) uint8 (0 = solve region), each
    placed at the top left of an (H, W) plane (the rest excluded), and
    their constraints (N, 4) x1 y1 x2 y2 in that plane's coordinates; a
    later duplicate constraint wins."""
    B = len(masks)
    m = np.zeros((B, H, W), np.float32)
    fit = np.zeros((B, H, W), np.float32)
    tgt = np.zeros((B, 2, H, W), np.float32)
    for k, (mk, c) in enumerate(zip(masks, cons)):
        h, w = mk.shape
        m[k, :h, :w] = mk == 0
        c = np.asarray(c, np.int64).reshape(-1, 4)
        fit[k, c[:, 1], c[:, 0]] = 1.0
        tgt[k, 0, c[:, 1], c[:, 0]] = c[:, 2]
        tgt[k, 1, c[:, 1], c[:, 0]] = c[:, 3]
    fit *= m
    tgt *= fit[:, None]
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float32)
    grid = np.repeat(np.stack([gx, gy])[None], B, 0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(
            dtype)

    mask = t(m)
    vm = torch.stack([mask * shift(mask, dy, dx) for dy, dx in DIRS], 1)
    return Problems(mask=mask, vm=vm, fit=t(fit), src=t(grid) * t(fit)[:, None],
                    tgt=t(tgt), grid=t(grid))


def _t_dir(s, c, dy, dx):
    return (-dx) * s - dy * c, dx * c - dy * s


def jtf_and_diag(x, P: Problems, cimg):
    """Gradient JᵀF and the Jacobi diagonal of JᵀJ, (B, 3, H, W) each."""
    o = x[:, :2]
    ox, oy = o[:, 0], o[:, 1]
    s, c = torch.sin(x[:, 2]), torch.cos(x[:, 2])
    g_o = torch.zeros_like(o)
    g_a = torch.zeros_like(s)
    for k, (dy, dx) in enumerate(DIRS):
        v = P.vm[:, k]
        oj = shift(o, dy, dx)
        ojx, ojy = oj[:, 0], oj[:, 1]
        ex = ox - ojx + (dx * c - dy * s)
        ey = oy - ojy + (dx * s + dy * c)
        sj, cj = shift(s, dy, dx), shift(c, dy, dx)
        exn = ojx - ox - (dx * cj - dy * sj)
        eyn = ojy - oy - (dx * sj + dy * cj)
        tx, ty = _t_dir(s, c, dy, dx)
        g_o = g_o + v[:, None] * torch.stack([ex - exn, ey - eyn], 1)
        g_a = g_a + v * (tx * ex + ty * ey)
    deg = P.vm.sum(1)
    jtf = torch.cat([W_REG * g_o + (W_FIT * P.fit)[:, None] * (o - cimg),
                     (W_REG * g_a)[:, None]], 1)
    diag_o = (2.0 * W_REG) * deg + W_FIT * P.fit
    return jtf, torch.stack([diag_o, diag_o, W_REG * deg], 1)


class JtJ:
    """JᵀJ at one linearisation (angles fixed), with its loop-constant
    planes formed once; ``update`` re-forms them in place at a new state."""

    def __init__(self, x, P: Problems):
        self.V2 = (2.0 * P.vm)[:, :, None]
        self.deg = P.vm.sum(1)
        self.fitw = (W_FIT * P.fit)[:, None]
        self.vm = P.vm
        self.T, self.TJ, self.sumT = self._planes(x)

    def _planes(self, x):
        s, c = torch.sin(x[:, 2]), torch.cos(x[:, 2])
        t, tj = [], []
        for k, (dy, dx) in enumerate(DIRS):
            v = self.vm[:, k]
            tx, ty = _t_dir(s, c, dy, dx)
            txj, tyj = _t_dir(shift(s, dy, dx), shift(c, dy, dx), dy, dx)
            t.append(torch.stack([v * tx, v * ty], 1))
            tj.append(torch.stack([v * txj, v * tyj], 1))
        T = torch.stack(t, 1)  # (B, 4, 2, H, W)
        return T, torch.stack(tj, 1), T.sum(1)

    def update(self, x):
        for dst, src in zip((self.T, self.TJ, self.sumT), self._planes(x)):
            dst.copy_(src)

    def __call__(self, p):
        H, W = p.shape[-2:]
        pp = F.pad(p, (1, 1, 1, 1))
        pj = torch.stack([pp[:, :, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
                          for dy, dx in DIRS], 1)  # (B, 4, 3, H, W)
        d = p[:, None, :2] - pj[:, :, :2]
        pa = p[:, 2]
        acc_o = ((self.V2 * d).sum(1) + pa[:, None] * self.sumT
                 + (self.TJ * pj[:, :, 2:]).sum(1))
        acc_a = (self.T * d).sum((1, 2)) + pa * self.deg
        return torch.cat([self.fitw * p[:, :2] + W_REG * acc_o,
                          (W_REG * acc_a)[:, None]], 1)


def _dot(a, b):
    return (a * b).sum((1, 2, 3))


class Pcg:
    """Jacobi-preconditioned CG from δ = 0 for a fixed count, on state held
    in place. On a CUDA device `per` iterations are captured once in a
    CUDA graph and replayed (a few dozen small operations an iteration
    would otherwise wait on their launches); the arithmetic is the same
    either way."""

    def __init__(self, A: JtJ, like: torch.Tensor, per: int = 20):
        self.A = A
        self.r, self.p, self.pre, self.delta = (torch.zeros_like(like)
                                                for _ in range(4))
        self.rz = torch.zeros(like.shape[0], dtype=like.dtype,
                              device=like.device)
        self.per, self.graph = per, None
        if like.is_cuda:
            side = torch.cuda.Stream(like.device)
            side.wait_stream(torch.cuda.current_stream(like.device))
            with torch.cuda.stream(side):
                self.step()  # warm up outside the capture
            torch.cuda.current_stream(like.device).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                for _ in range(per):
                    self.step()

    def step(self):
        ap = self.A(self.p)
        pap = _dot(self.p, ap)
        alpha = torch.where(pap > 0, self.rz / pap, 0.0)[:, None, None, None]
        self.delta.add_(alpha * self.p)
        self.r.sub_(alpha * ap)
        z = self.pre * self.r
        rz_new = _dot(z, self.r)
        beta = torch.where(self.rz > 0, rz_new / self.rz,
                           0.0)[:, None, None, None]
        self.p.copy_(z + beta * self.p)
        self.rz.copy_(rz_new)

    def __call__(self, b, pre, iters: int):
        self.pre.copy_(pre)
        self.r.copy_(b)
        z = pre * b
        self.p.copy_(z)
        self.rz.copy_(_dot(b, z))
        self.delta.zero_()
        n = 0
        if self.graph is not None:
            for _ in range(iters // self.per):
                self.graph.replay()
            n = iters // self.per * self.per
        for _ in range(iters - n):
            self.step()
        return self.delta.clone()


def solve(P: Problems, schedule=(19, 8, 400)) -> torch.Tensor:
    """The annealed schedule (num_anneal, gn_iters, pcg_iters); returns the
    state x (B, 3, H, W): warped positions and angles."""
    num_anneal, gn_iters, pcg_iters = schedule
    x = torch.cat([P.grid, torch.zeros_like(P.grid[:, :1])], 1)
    A = JtJ(x, P)
    cg = Pcg(A, x)
    for i in range(num_anneal):
        a = np.float32(i + 1.0) / np.float32(num_anneal)
        cimg = float(np.float32(1.0) - a) * P.src + float(a) * P.tgt
        for _ in range(gn_iters):
            jtf, diag = jtf_and_diag(x, P, cimg)
            pre = 1.0 / torch.square(1.0 + torch.sqrt(diag))
            A.update(x)
            x = x + cg(-jtf, pre, pcg_iters)
    return x
