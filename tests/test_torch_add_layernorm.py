"""The residual stream's add-and-normalise (`ops.cuda.add_layernorm`): its
plain version against PyTorch's composition, bit for bit, in each form
(add + norm, add + cast, no add with f32 or bf16 out) at SwinIR-S, -M and
-L's widths; in place and out of place; the wrapper's argument checks.
The tests marked ``cuda`` hold the kernel to its plain version on the
card:

    python -m pytest --noconftest tests/test_torch_add_layernorm.py -q -m cuda

On the card ``s`` must be bit-identical (one f32 add, as PyTorch's), and
``h`` close to the plain version on every element (`_close`): the
statistics are the same f32 quantities summed in another order, so a
bf16 ``h`` can differ by one bf16 unit only where its value lies next to
a rounding boundary, and must be identical on at least 99.9% of the
elements.  An f32 ``h`` (the patch embedding's) is held to 16 f32 units
of its magnitude and 2^-20 besides: two f32 LayerNorms differ by a few
f32 units where |h| is large (PyTorch's own f32 LayerNorm is 1.1e-6 from
the float64 one at |h| near 6), while an ``h`` rounded through bf16 on
its way to f32 is off by up to half a bf16 unit, which that bound
refuses (`test_f32_h_bound_refuses_a_bf16_rounding`).
"""

import pytest
import torch
import torch.nn.functional as F

from rusty_sr_tpu_torch.ops.cuda import add_layernorm as al

EPS = 1e-5
BF16, F32 = torch.bfloat16, torch.float32
# (has y, has norm, h's type): add + norm, add + cast, no add to f32 (the
# patch embedding) and no add to bf16 (a group's first norm1)
FORMS = [(True, True, BF16), (True, False, BF16), (False, True, F32),
         (False, True, BF16)]


def _inputs(n, c, seed, device="cpu", x_dtype=F32):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(n, c, generator=g) * 3.0 + 0.5).to(x_dtype)
    y = torch.randn(n, c, generator=g).to(BF16)
    w = 1.0 + 0.1 * torch.randn(c, generator=g)
    b = 0.1 * torch.randn(c, generator=g)
    return [t.to(device) for t in (x, y, w, b)]


def _composition(x, y, norm, out_dtype):
    """What the SwinIR forward ran before the op: the mixed-type add,
    ``F.layer_norm`` on f32 and the cast."""
    s = x if y is None else x + y
    if norm is None:
        return s, s.to(out_dtype)
    return s, F.layer_norm(s.float(), (s.shape[-1],), norm[0], norm[1],
                           EPS).to(out_dtype)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("c", [60, 180, 240])
@pytest.mark.parametrize("n", [1, 37, 1001])
def test_reference_is_the_composition(form, c, n):
    has_y, has_norm, out_dtype = form
    x, y, w, b = _inputs(n, c, n + c)
    if not has_y and out_dtype == F32:
        x = x.to(BF16)          # the patch embedding reads the conv's bf16
    y = y if has_y else None
    norm = (w, b) if has_norm else None
    s, h = al.add_layernorm_reference(x, y, norm, out_dtype, eps=EPS)
    want_s, want_h = _composition(x, y, norm, out_dtype)
    assert s.dtype == want_s.dtype and torch.equal(s, want_s)
    assert h.dtype == out_dtype and torch.equal(h, want_h)
    # the wrapper takes the plain version on the CPU
    s2, h2 = al.add_layernorm(x, y, norm, out_dtype, eps=EPS)
    assert torch.equal(s2, want_s) and torch.equal(h2, want_h)


@pytest.mark.parametrize("in_place", [True, False])
def test_in_place_and_out_of_place(in_place):
    x, y, w, b = _inputs(37, 180, 1)
    x0 = x.clone()
    x_out = x if in_place else torch.empty_like(x)
    s, h = al.add_layernorm(x, y, (w, b), BF16, x_out, EPS)
    assert s is x_out
    assert torch.equal(s, x0 + y)
    assert torch.equal(x, x0 + y) if in_place else torch.equal(x, x0)
    assert torch.equal(h, _composition(x0, y, (w, b), BF16)[1])


def test_h_is_always_fresh():
    """A cast to the input's own type is still a new tensor, so that a
    caller may write into ``s`` while it still reads ``h``."""
    x = _inputs(5, 60, 2)[0]
    s, h = al.add_layernorm(x, None, None, F32)
    assert s is x and torch.equal(h, x)
    assert h.data_ptr() != x.data_ptr()


def test_a_fresh_x_out_when_none_is_given():
    x, y, w, b = _inputs(9, 60, 3)
    x0 = x.clone()
    s, _ = al.add_layernorm(x, y, (w, b))
    assert s.data_ptr() != x.data_ptr() and torch.equal(x, x0)


def test_kernel_takes_cuda_rows_of_multiples_of_four():
    x = torch.zeros(3, 180)
    assert not al.kernel_takes(x)        # a CPU tensor
    meta = torch.zeros(3, 180, device="meta")
    assert not al.kernel_takes(meta)


def _bad_calls():
    x, y, w, b = _inputs(8, 60, 4)
    return {
        "x f64": (TypeError, lambda: al.add_layernorm(x.double())),
        "y f32": (TypeError, lambda: al.add_layernorm(x, y.float())),
        "x bf16 with y": (TypeError, lambda: al.add_layernorm(x.to(BF16), y)),
        "h f16": (TypeError, lambda: al.add_layernorm(x, None, None,
                                                     torch.float16)),
        "y shape": (ValueError, lambda: al.add_layernorm(x, y[:4])),
        "x_out shape": (ValueError, lambda: al.add_layernorm(
            x, y, None, BF16, torch.empty(4, 60))),
        "x_out bf16": (ValueError, lambda: al.add_layernorm(
            x, y, None, BF16, torch.empty(8, 60, dtype=BF16))),
        "x_out without y": (ValueError, lambda: al.add_layernorm(
            x, None, None, BF16, torch.empty_like(x))),
        "norm width": (ValueError, lambda: al.add_layernorm(
            x, y, (w[:30], b[:30]))),
        "norm f64": (ValueError, lambda: al.add_layernorm(
            x, y, (w.double(), b))),
        "scalar x": (ValueError, lambda: al.add_layernorm(torch.tensor(1.0))),
        "norm device": (ValueError, lambda: al.add_layernorm(
            x, y, (w.to("meta"), b))),
        "x device": (ValueError, lambda: al.add_layernorm(
            x.to("meta"), None, None, F32)),
        "x strided": (ValueError, lambda: al.add_layernorm(
            torch.zeros(60, 8).t(), None)),
        "y strided": (ValueError, lambda: al.add_layernorm(
            x, torch.zeros(60, 8, dtype=BF16).t())),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_raises(case):
    err, call = _bad_calls()[case]
    with pytest.raises(err):
        call()


# --- on the card ---

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _unit(v: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at each of ``v``'s magnitudes, or
    2^-20 where that is larger: the statistics' absolute error (about
    1e-8 at these inputs) can move a value near zero by more than its own
    unit."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return (torch.exp2(e) * torch.finfo(BF16).eps).clamp_min(2.0 ** -20)


def _close(h_k: torch.Tensor, h_p: torch.Tensor) -> bool:
    """``h_k`` against the plain ``h_p`` of the same type: one bf16 unit
    (`_unit`) for a bf16 ``h``; 16 f32 units of |h_p| and 2^-20 besides
    for an f32 one (see the module)."""
    d = (h_k.float() - h_p.float()).abs()
    if h_p.dtype == BF16:
        return bool((d <= _unit(h_p.float())).all())
    return bool((d <= 16 * h_p.abs() * 2.0 ** -23 + 2.0 ** -20).all())


def test_f32_h_bound_refuses_a_bf16_rounding():
    """A planted fault: the patch norm's f32 ``h`` rounded through bf16
    before it is stored.  `_close` must refuse it, and take the plain
    ``h`` itself and one a few f32 units off."""
    x, _, w, b = _inputs(1001, 180, 5, x_dtype=BF16)
    _, h_p = al.add_layernorm_reference(x, None, (w, b), F32, eps=EPS)
    assert _close(h_p, h_p)
    assert _close(h_p * (1 + 3 * 2.0 ** -23), h_p)
    assert not _close(h_p.to(BF16).float(), h_p)


def _held_to_plain(x, y, norm, out_dtype, in_place):
    """The kernel against the plain version on copies of the same
    inputs; returns h's share of elements identical to the plain one's."""
    x_k, x_p = x.clone(), x.clone()
    out_k = x_k if in_place else (torch.empty_like(x) if y is not None
                                  else None)
    out_p = x_p if in_place else None
    n = al.LAUNCHES
    s_k, h_k = al.add_layernorm(x_k, y, norm, out_dtype, out_k, EPS)
    torch.cuda.synchronize()
    assert al.LAUNCHES == n + 1
    s_p, h_p = al.add_layernorm_reference(x_p, y, norm, out_dtype, out_p,
                                          EPS)
    assert torch.equal(s_k, s_p)
    if y is not None:
        assert (s_k.data_ptr() == x_k.data_ptr()) == in_place
        if not in_place:
            assert torch.equal(x_k, x)       # x untouched
    assert _close(h_k, h_p)
    return float((h_k == h_p).float().mean())


# every form, in place and out of place where it writes x_out
CASES = [(form, in_place) for form in FORMS
         for in_place in ((True, False) if form[0] else (False,))]


def _run(device, n, c, form, in_place, seed):
    has_y, has_norm, out_dtype = form
    x, y, w, b = _inputs(n, c, seed, device,
                         BF16 if not has_y and out_dtype == F32 else F32)
    same = _held_to_plain(x, y if has_y else None,
                          (w, b) if has_norm else None, out_dtype, in_place)
    if out_dtype == BF16 and n * c >= 10000:
        assert same >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("form,in_place", CASES)
def test_kernel_matches_plain_at_the_cell(cuda_device, form, in_place):
    """The SwinIR cell's frame: 544 x 960 padded tokens at C = 180."""
    _run(cuda_device, 544 * 960, 180, form, in_place, 7)


@pytest.mark.cuda
@pytest.mark.parametrize("form,in_place", CASES)
@pytest.mark.parametrize("c", [60, 240])
@pytest.mark.parametrize("n", [1, 37, 1001])
def test_kernel_matches_plain_small(cuda_device, form, in_place, c, n):
    """SwinIR-S and -L's widths on row counts that fill no whole block."""
    _run(cuda_device, n, c, form, in_place, n * c)


@pytest.mark.cuda
def test_kernel_refuses_other_widths(cuda_device):
    x = torch.zeros(4, 90, device=cuda_device)
    assert not al.kernel_takes(x)
    with pytest.raises(ValueError, match="multiple of 4"):
        al.add_layernorm(x)
    assert al.kernel_takes(torch.zeros(4, 512, device=cuda_device))
    assert not al.kernel_takes(torch.zeros(4, 516, device=cuda_device))
