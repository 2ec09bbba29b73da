"""Hash-dropout masks of the composition's sites: the CUDA kernels' wrappers, their plain
PyTorch versions and the launch counters.

Where a block runs outside the fused kernels (the composition of ``models/layers.py``:
the projection's output and the MLP's hidden and output under ``cuda``, every site of the
blocks gated to the composition), its dropout masks come from the TPU kernels' hash keyed
on K4's geometry (``ops/dropout_layout.py``, ``"k4"``). The plain versions build each mask
from int64 tensors (``dl.token_keep``, ``dl.attention_keep``), some 25 elementwise
launches per masked tensor; on a card one launch of ``csrc/dropout_mask.cu`` applies it
(the token sites' kernel takes a token row to a group of threads, hashes the row's unit
once and moves 16-byte vectors; a call copies its site's cached arguments and sets only
the seed's hash base):

- :func:`token_dropout`: a token site on (S, B, H, W, cols) in image order;
- :func:`attention_dropout`: the attention weights (S, B*nWin, heads, T, T) of the
  composition's windows (``dl.composition_windows``).

Both return ``keep ? x * scale : 0`` with the float32 scale of ``hash_dropout.keep_scale``,
as ``hash_dropout.apply_mask`` does (on a bf16 tensor the product is taken in fp32 and
rounded once, as PyTorch multiplies a bf16 tensor by a float), and both versions' backward
applies the same mask to the gradient. A CPU tensor takes the plain version, a CUDA tensor
(fp32 or bf16) the kernel; there is no fallback between the two. Forward and backward
launches count apart, and bf16 launches apart from fp32 ones.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from . import dropout_layout as dl
from . import hash_dropout as hd

# Calls that launched each kernel, forward and on a gradient, on fp32 and on bf16 tensors,
# since the last reset; the plain versions never count.
TOKEN_LAUNCHES = 0
TOKEN_BWD_LAUNCHES = 0
ATTN_LAUNCHES = 0
ATTN_BWD_LAUNCHES = 0
BF16_TOKEN_LAUNCHES = 0
BF16_TOKEN_BWD_LAUNCHES = 0
BF16_ATTN_LAUNCHES = 0
BF16_ATTN_BWD_LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def token_dropout_plain(a: torch.Tensor, seed: int, site: int, rate: float,
                        key: dl.Keying) -> torch.Tensor:
    """Hash dropout of token site ``site`` (``hd.SITE_PROJ``, ``SITE_MLP_HIDDEN`` or
    ``SITE_MLP_OUT``) on ``a`` (S, B, H, W, cols), tokens keyed by ``key`` in image order."""
    keep = dl.token_keep(seed, site, rate, key, a.shape[0], a.shape[1], a.shape[-1])
    return hd.apply_mask(a, keep.reshape(a.shape), rate)


def attention_dropout_plain(weights: torch.Tensor, seed: int, rate: float,
                            key: dl.Keying) -> torch.Tensor:
    """Hash dropout of the attention weights (S, B*nWin, heads, T, T) of the composition's
    windows of the map ``key`` was made for."""
    windows = dl.composition_windows(key)
    s, bw, heads = weights.shape[:3]
    keep = dl.attention_keep(seed, rate, key, windows, s, bw // windows.shape[0], heads)
    return hd.apply_mask(weights, keep.reshape(weights.shape), rate)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load("dropout_mask")
    drop = ctypes.POINTER(dl.DropArgs)
    lib.swin_dropout_tokens.argtypes = [_P, _P, drop] + [_I] * 6 + [_P]
    lib.swin_dropout_tokens.restype = _I
    lib.swin_dropout_attention.argtypes = [_P, _P, drop, _P] + [_I] * 6 + [_P]
    lib.swin_dropout_attention.restype = _I
    lib.swin_dropout_tokens_elementwise.argtypes = lib.swin_dropout_tokens.argtypes
    lib.swin_dropout_tokens_elementwise.restype = _I
    return lib


# (site, rate and the keying's fields) -> the arguments of that one site at seed 0: a call
# copies them and sets the seed's hash base, instead of building them anew (some 10 µs)
_TEMPLATES = {}


@functools.lru_cache(maxsize=4096)
def _site_base(seed: int, site: int) -> int:
    return hd.site_base(seed, site)


def _site_args(key: dl.Keying, site: int, rate: float, seed: int) -> dl.DropArgs:
    """``dl.drop_args`` with ``rate`` at ``site`` and every other site off, bit for bit."""
    index = hd.SITES.index(site)
    at = (site, rate, key.table.data_ptr(), key.table.device, key.units, key.pairs, key.attn_mode,
          key.t_pad)
    template = _TEMPLATES.get(at)
    if template is None:
        rates = [0.0] * len(hd.SITES)
        rates[index] = rate
        template = _TEMPLATES[at] = dl.drop_args(key, rates, 0)
    args = dl.DropArgs.from_buffer_copy(template)
    args.base[index] = _site_base(seed, site)
    return args


def _token_launch(launcher, a: torch.Tensor, seed: int, site: int, rate: float,
                  key: dl.Keying) -> torch.Tensor:
    """``a`` contiguous through ``launcher`` (``swin_dropout_tokens``, or its first form
    ``swin_dropout_tokens_elementwise``, which only ``chip_smoke.py``'s timings in turns call)."""
    s, b, h, w, cols = a.shape
    args = _site_args(key, site, rate, seed)
    out = torch.empty_like(a)
    rc = _build.launch_on(a.device, launcher, a.data_ptr(), out.data_ptr(), dl.drop_pointer(args),
                          hd.SITES.index(site), s, b, h * w, cols, int(a.dtype == torch.bfloat16))
    _build.check_launch(_library(), rc, "token dropout mask")
    return out


def _launch_tokens(a: torch.Tensor, seed: int, site: int, rate: float, key: dl.Keying,
                   backward: bool = False) -> torch.Tensor:
    global TOKEN_LAUNCHES, TOKEN_BWD_LAUNCHES, BF16_TOKEN_LAUNCHES, BF16_TOKEN_BWD_LAUNCHES
    a = a.contiguous()
    bf16 = a.dtype == torch.bfloat16
    out = _token_launch(_library().swin_dropout_tokens, a, seed, site, rate, key)
    if backward and bf16:
        BF16_TOKEN_BWD_LAUNCHES += 1
    elif backward:
        TOKEN_BWD_LAUNCHES += 1
    elif bf16:
        BF16_TOKEN_LAUNCHES += 1
    else:
        TOKEN_LAUNCHES += 1
    return out


def _launch_attention(weights: torch.Tensor, seed: int, rate: float, key: dl.Keying,
                      backward: bool = False) -> torch.Tensor:
    global ATTN_LAUNCHES, ATTN_BWD_LAUNCHES, BF16_ATTN_LAUNCHES, BF16_ATTN_BWD_LAUNCHES
    weights = weights.contiguous()
    bf16 = weights.dtype == torch.bfloat16
    windows = dl.composition_windows(key)
    s, bw, heads, t, _ = weights.shape
    args = _site_args(key, hd.SITE_ATTN, rate, seed)
    out = torch.empty_like(weights)
    lib = _library()
    rc = _build.launch_on(weights.device, lib.swin_dropout_attention, weights.data_ptr(),
                          out.data_ptr(), dl.drop_pointer(args), windows.data_ptr(), s,
                          bw // windows.shape[0], windows.shape[0], t, heads, int(bf16))
    _build.check_launch(lib, rc, "attention dropout mask")
    if backward and bf16:
        BF16_ATTN_BWD_LAUNCHES += 1
    elif backward:
        ATTN_BWD_LAUNCHES += 1
    elif bf16:
        BF16_ATTN_LAUNCHES += 1
    else:
        ATTN_LAUNCHES += 1
    return out


class _MaskFunction(torch.autograd.Function):
    """A mask kernel's launch, and the same launch on the gradient."""

    @staticmethod
    def forward(ctx, launch, a):
        ctx.launch = launch
        return launch(a)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.launch(g, backward=True)


def _check(a: torch.Tensor, key: dl.Keying, ndim: int, what: str) -> None:
    if a.device.type != "cuda":
        raise ValueError(f"the {what} dropout mask runs on cpu or cuda tensors, not {a.device}")
    if a.dtype not in (torch.float32, torch.bfloat16) or a.ndim != ndim:
        raise ValueError(f"the {what} dropout mask takes a float32 or bfloat16 tensor of "
                         f"{ndim} dimensions, got {a.dtype} {tuple(a.shape)}")
    if key.table.device != a.device or key.geometry[0] != "k4":
        raise ValueError(f"the {what} dropout mask needs a 'k4' keying on {a.device}, got "
                         f"{key.geometry[0]!r} on {key.table.device}")


def _apply(launch, a: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and a.requires_grad:
        return _MaskFunction.apply(launch, a)
    return launch(a)


def token_dropout(a: torch.Tensor, seed: int, site: int, rate: float,
                  key: dl.Keying) -> torch.Tensor:
    """:func:`token_dropout_plain` on the CPU, one kernel launch on a card."""
    if a.device.type == "cpu":
        return token_dropout_plain(a, seed, site, rate, key)
    _check(a, key, 5, "token")
    h, w = key.geometry[1]
    if tuple(a.shape[2:4]) != (h, w) or site not in hd.SITES[1:]:
        raise ValueError(f"token site {site} on {tuple(a.shape)} with a keying of a {h}x{w} map")
    return _apply(functools.partial(_launch_tokens, seed=seed, site=site, rate=rate, key=key), a)


def attention_dropout(weights: torch.Tensor, seed: int, rate: float,
                      key: dl.Keying) -> torch.Tensor:
    """:func:`attention_dropout_plain` on the CPU, one kernel launch on a card."""
    if weights.device.type == "cpu":
        return attention_dropout_plain(weights, seed, rate, key)
    _check(weights, key, 5, "attention")
    n_win, t = dl.composition_windows(key).shape[:2]
    if weights.shape[1] % n_win or weights.shape[3:] != (t, t):
        raise ValueError(f"attention weights {tuple(weights.shape)} do not hold windows of "
                         f"{t} tokens of a {key.geometry[1]} map")
    return _apply(functools.partial(_launch_attention, seed=seed, rate=rate, key=key), weights)
