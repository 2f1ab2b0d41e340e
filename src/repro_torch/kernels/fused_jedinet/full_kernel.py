"""Whole-network fused JEDI-net forward (x -> logits): wrapper and plain version.

Port of ``repro.kernels.fused_jedinet.full_kernel``.  The TPU kernel
``_tiled_forward_kernel`` becomes the hand-written CUDA kernel in
``kernels/csrc/fused_jedinet_full.cu`` (see its header for the design
and what bounds it).  This module holds, side by side:

* :func:`fused_forward_full_kernel_call` — the wrapper.  On a CUDA
  tensor it checks shapes, types and devices, allocates the logits with
  ``torch.empty`` and launches the kernel on the current stream through
  ``ctypes`` (raising on a non-zero ``cudaError_t``); on a CPU tensor it
  runs the plain version.  It never catches and falls back.
  ``fused_forward_full_kernel_call.launches`` counts the launches.
* :func:`fused_forward_full_plain` — the same function in plain PyTorch,
  with the kernel's sender tiling and self-edge masking: the CPU tests
  use it, and ``chip_smoke.py`` holds the kernel against it on the card.
* :class:`KernelWeights` — the weights split, flattened and packed once
  (one weight buffer in its own dtype, one fp32 bias buffer, the int8
  scales), so a served batch only launches.

Precision: ``x.dtype`` is the compute dtype.  In bf16 every operand of a
product is rounded to bf16, sums stay fp32 and biases stay fp32; int8
weights multiply the fp32 sum by their tensor's scale before the bias.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_jedinet import autotune
from repro_torch.nn.core import ACTIVATIONS

LIB_NAME = "fused_jedinet_full"
SOURCES = ("fused_jedinet_full.cu",)

#: The kernel's launch header, in the order of ``JEDI_HEADER_FIELDS`` in
#: the CUDA source (a CPU test keeps the two in step).
HEADER_FIELDS = (
    "x_bf16", "w_kind", "compute_bf16", "act", "quant",
    "batch", "n_o", "p", "d_e", "d_o", "n_targets",
    "n_fr", "n_fo", "n_phi",
    "epb", "bs", "ks", "team", "threads", "mw", "slot_stride",
    "off_w", "off_b", "off_x", "off_ebar", "off_part", "off_us", "off_obuf",
    "off_osum", "off_slot",
    "w_total", "b_total", "h1_p", "de_p", "do_p", "smem_words",
)

#: Activation name -> the kernel's code (the order of ``ACTIVATIONS``).
ACT_CODES = {name: i for i, name in enumerate(ACTIVATIONS)}

_W_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _is_int(w: torch.Tensor) -> bool:
    return not (w.is_floating_point() or w.is_complex())


def split_first_layer(params_fr, n_features: int, dtype=torch.float32):
    """f_R's first-layer weight split into receiver / sender halves.

    Weights are cast to ``dtype`` (the compute dtype), int8 weights keep
    their dtype (both halves share w1's scale); biases are fp32.
    Returns ``(w1r, w1s, b1, [w2, b2, ...])``.
    """
    def wcast(w):
        return w if _is_int(w) else w.to(dtype)

    layers = params_fr["layers"]
    w1 = wcast(layers[0]["w"])
    b1 = layers[0]["b"].float()
    rest = []
    for lp in layers[1:]:
        rest.append(wcast(lp["w"]))
        rest.append(lp["b"].float())
    return w1[:n_features], w1[n_features:], b1, rest


def flatten_mlp(params, dtype):
    """``[w0, b0, w1, b1, ...]``: weights cast to ``dtype`` (int8 kept),
    biases fp32."""
    flat = []
    for lp in params["layers"]:
        w = lp["w"]
        flat.append(w if _is_int(w) else w.to(dtype))
        flat.append(lp["b"].float())
    return flat


def mlp_scales(params) -> list:
    """Per-layer dequant scales of a quantized MLP (fp32 scalars)."""
    return [lp["w_scale"] for lp in params["layers"]]


def _mmq(h, w, scale, bf16: bool):
    """``h @ w`` with fp32 sums; bf16 rounds both operands first; an int8
    weight's ``scale`` multiplies the fp32 result."""
    wf = w.float()
    if bf16:
        h = h.to(torch.bfloat16).float()
        wf = wf.to(torch.bfloat16).float()
    out = h @ wf
    return out if scale is None else out * scale


def fused_forward_full_plain(x, fr_arrays, fo_arrays, phi_arrays, *,
                             activation: str, scales=None,
                             block_s: int | None = None):
    """The kernel's function in plain PyTorch. x: (B, N_o, P) -> (B, T) fp32.

    ``fr_arrays = [w1r, w1s, b1, w2, b2, ...]``; ``scales`` one fp32
    scalar per weight tensor ``[w1r, w1s, w2.., fo.., phi..]`` for int8
    weights, else None.  Senders are taken ``block_s`` at a time (all at
    once by default); the self-edge is masked out before the sum.
    """
    bf16 = x.dtype == torch.bfloat16
    act = ACTIVATIONS[activation]
    n_fr = 1 + (len(fr_arrays) - 3) // 2
    n_fo, n_phi = len(fo_arrays) // 2, len(phi_arrays) // 2
    s = list(scales) if scales is not None \
        else [None] * (n_fr + 1 + n_fo + n_phi)
    w1r, w1s, b1, rest = fr_arrays[0], fr_arrays[1], fr_arrays[2], \
        fr_arrays[3:]
    xf = x.float()
    bsz, n_o, _ = x.shape
    bs = n_o if block_s is None else max(1, min(int(block_s), n_o))
    u_r = _mmq(xf, w1r, s[0], bf16)                          # (B, N_o, H1)
    d_e = (rest[-2] if rest else w1r).shape[-1]
    acc = xf.new_zeros((bsz, n_o, d_e))
    recv = torch.arange(n_o, device=x.device)[:, None]
    for s0 in range(0, n_o, bs):
        xs = xf[:, s0:s0 + bs]
        u_s = _mmq(xs, w1s, s[1], bf16)                      # (B, S, H1)
        h = u_r[:, :, None, :] + u_s[:, None, :, :] + b1.float()
        if n_fr > 1:
            h = act(h)
        for li in range(n_fr - 1):
            h = _mmq(h, rest[2 * li], s[2 + li], bf16) + rest[2 * li + 1]
            if li < n_fr - 2:
                h = act(h)
        send = torch.arange(s0, s0 + xs.shape[1], device=x.device)[None, :]
        keep = (recv != send)[None, :, :, None]
        acc = acc + torch.where(keep, h, torch.zeros_like(h)).sum(2)
    h = torch.cat([xf, acc], dim=-1)
    for li in range(n_fo):
        h = _mmq(h, fo_arrays[2 * li], s[n_fr + 1 + li], bf16) \
            + fo_arrays[2 * li + 1]
        if li < n_fo - 1:
            h = act(h)
    h = h.sum(1)                                             # (B, D_o)
    for li in range(n_phi):
        h = _mmq(h, phi_arrays[2 * li], s[n_fr + 1 + n_fo + li], bf16) \
            + phi_arrays[2 * li + 1]
        if li < n_phi - 1:
            h = act(h)
    return h.float()


@dataclasses.dataclass
class KernelWeights:
    """Split, flattened weights plus their packed form for the kernel.

    ``fr``/``fo``/``phi`` are the flat lists the plain version takes;
    ``scales`` the int8 scales (fp32 0-d tensors) or None.  On a CUDA
    device :meth:`pack` lays them out once as the kernel reads them:
    each weight tensor ``(in, out)`` padded to ``(in, out_p)`` with zero
    columns, all in one buffer of the weights' dtype; the biases padded
    the same way in one fp32 buffer.
    """

    fr: list
    fo: list
    phi: list
    scales: list | None
    n_features: int
    wpack: torch.Tensor | None = None
    bpack: torch.Tensor | None = None
    _launch_cache: dict = dataclasses.field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return self.fr[0].device

    def widths(self):
        fr_w = [int(self.fr[0].shape[-1])] + [int(w.shape[-1])
                                              for w in self.fr[3::2]]
        return (fr_w, [int(w.shape[-1]) for w in self.fo[0::2]],
                [int(w.shape[-1]) for w in self.phi[0::2]])

    def weights_and_biases(self):
        """``[(w, b or None)]`` in kernel entry order (w1s has no bias)."""
        fr = [(self.fr[0], self.fr[2]), (self.fr[1], None)]
        fr += list(zip(self.fr[3::2], self.fr[4::2]))
        return (fr + list(zip(self.fo[0::2], self.fo[1::2]))
                + list(zip(self.phi[0::2], self.phi[1::2])))

    def pack(self) -> "KernelWeights":
        if self.wpack is not None:
            return self
        entries = autotune.kernel_entries(self.n_features, *self.widths())
        pairs = self.weights_and_biases()
        dtypes = {w.dtype for w, _ in pairs}
        if len(dtypes) != 1 or next(iter(dtypes)) not in _W_KINDS:
            raise TypeError(
                f"the kernel takes weights all fp32, all bf16 or all int8; "
                f"got {sorted(str(d) for d in dtypes)}")
        ws, bs = [], []
        for (w, b), ent in zip(pairs, entries):
            pad = ent.out_p - ent.out_dim
            ws.append(torch.nn.functional.pad(w, (0, pad)).reshape(-1)
                      if pad else w.reshape(-1))
            if b is not None:
                bs.append(torch.nn.functional.pad(b.float(), (0, pad)))
        b = torch.cat(bs)
        b = torch.nn.functional.pad(b, (0, -len(b) % 4))
        self.wpack = torch.cat(ws).contiguous()
        self.bpack = b.contiguous()
        return self

    def launch_header(self, n_o: int, n_targets: int, block_s):
        """(layout, header values without batch/x dtype) for one shape;
        cached, so a served batch does no layout work."""
        key = (n_o, n_targets, block_s)
        hit = self._launch_cache.get(key)
        if hit is not None:
            return hit
        fr_w, fo_w, phi_w = self.widths()
        if phi_w[-1] != n_targets:
            raise ValueError(f"phi_O has {phi_w[-1]} outputs, not "
                             f"n_targets={n_targets}")
        lay = autotune.plan_launch(n_o, self.n_features, fr_w, fo_w, phi_w,
                                   block_s=block_s)
        entries = autotune.kernel_entries(self.n_features, fr_w, fo_w, phi_w)
        o = lay.offsets
        head = dict(
            w_kind=_W_KINDS[self.fr[0].dtype], act=0,
            quant=int(self.scales is not None), n_o=n_o, p=self.n_features,
            d_e=fr_w[-1], d_o=fo_w[-1], n_targets=n_targets,
            n_fr=len(fr_w) + 1, n_fo=len(fo_w), n_phi=len(phi_w),
            epb=lay.events_per_block, bs=lay.block_s, ks=lay.ks,
            team=lay.team, threads=lay.threads, mw=lay.mw,
            slot_stride=lay.slot_stride,
            off_w=o["w"], off_b=o["b"], off_x=o["x"], off_ebar=o["ebar"],
            off_part=o["part"], off_us=o["us"], off_obuf=o["obuf"],
            off_osum=o["osum"], off_slot=o["slot"],
            w_total=sum(e.in_dim * e.out_p for e in entries),
            b_total=int(self.bpack.numel()) if self.bpack is not None else 0,
            h1_p=entries[0].out_p, de_p=entries[len(fr_w)].out_p,
            do_p=entries[len(fr_w) + len(fo_w)].out_p,
            smem_words=lay.smem_words)
        ent = [v for e in entries
               for v in (e.in_dim, e.out_dim, e.out_p, e.w_off, e.b_off)]
        scales = [float(s) for s in self.scales] if self.scales is not None \
            else [1.0] * len(entries)
        hit = (lay, head, ent, (ctypes.c_float * len(scales))(*scales))
        self._launch_cache[key] = hit
        return hit


def _lib():
    lib = build.load_library(LIB_NAME, SOURCES)
    fn = lib.jedi_fused_full_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.jedi_fused_full_header_len.restype = ctypes.c_int
        n = lib.jedi_fused_full_header_len()
        if n != len(HEADER_FIELDS):
            raise RuntimeError(f"kernel header has {n} fields, the wrapper "
                               f"{len(HEADER_FIELDS)}: rebuild in step")
    return lib


def fused_forward_full_kernel_call(x: torch.Tensor, weights: KernelWeights,
                                   *, activation: str, n_targets: int,
                                   block_s: int | None = None):
    """x: (B, N_o, P) fp32 or bf16 (the compute dtype) -> logits (B, T) fp32.

    CUDA tensors launch the kernel (no batch padding: the kernel masks
    the ragged last block); CPU tensors run :func:`fused_forward_full_plain`.
    ``block_s`` pins the sender tile (default: the autotuner's choice).  Raises on shapes, types or devices the kernel
    does not take.
    """
    if x.dim() != 3 or x.shape[2] != weights.n_features:
        raise ValueError(f"x must be (B, N_o, {weights.n_features}); "
                         f"got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    if activation not in ACT_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    if x.device != weights.device:
        raise ValueError(f"x is on {x.device}, the weights on "
                         f"{weights.device}")
    if x.device.type == "cpu":
        return fused_forward_full_plain(
            x, weights.fr, weights.fo, weights.phi, activation=activation,
            scales=weights.scales, block_s=block_s)
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    weights.pack()
    _, head, ent, scales = weights.launch_header(
        x.shape[1], n_targets, block_s)
    bf16 = int(x.dtype == torch.bfloat16)
    vals = dict(head, x_bf16=bf16, compute_bf16=bf16,
                act=ACT_CODES[activation], batch=x.shape[0])
    meta_list = [vals[f] for f in HEADER_FIELDS] + ent
    meta = (ctypes.c_int * len(meta_list))(*meta_list)
    out = torch.empty((x.shape[0], n_targets), dtype=torch.float32,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _lib().jedi_fused_full_launch(
        x.data_ptr(), weights.wpack.data_ptr(), weights.bpack.data_ptr(),
        out.data_ptr(), meta, len(meta_list), scales, stream)
    if err != 0:
        raise RuntimeError(
            f"jedi_fused_full_launch failed: cudaError_t {err} "
            f"({torch.cuda.get_device_name(x.device)}, batch {x.shape[0]}, "
            f"N_o {x.shape[1]}, {head['threads']} threads, "
            f"{4 * head['smem_words']} B shared memory)")
    fused_forward_full_kernel_call.launches += 1
    return out


fused_forward_full_kernel_call.launches = 0
