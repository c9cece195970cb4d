"""The TMA maps of kernel 8's bf16 forward at D 64 and 128, on the CPU.

At D 64 and 128 the bf16 forward (csrc/flash_attention.cu,
`flash_attention_ws_kernel`) takes q, k and v by TMA. The wrapper hands the
C entry point each tensor's map geometry from `tma_map_geometry`: dims
innermost first (D, S, H, B), the byte strides of S, H and B, and the box
(64, 128, 1, 1), one 128-byte swizzled panel of 128 rows. The kernel asks
for boxes at (64 x panel, row, head, batch). A wrong stride would read
another head's rows with no error on the card, so the geometry is held
here to hand-computed values on CPU tensors. Both layouts the port passes
are covered: the model layout [B, S, H, D] as a transposed view, and the
contiguous kernel layout [B, H, S, D]. Strides a map cannot express must
raise; there is no fallback. The table of which kernel each bf16 head dim
launches, which chip_smoke.py's symbol checks and the card tests read, is
held to the source's dispatch.
"""
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402

BF16 = torch.bfloat16
BOX = (64, 128, 1, 1)


@pytest.mark.parametrize("b,s,h,d", [
    (4, 4096, 32, 64),      # granite's train layer
    (1, 4096, 64, 128),     # llama-vision's
    (2, 1000, 5, 64),       # ragged length, hymba's KV heads
    (1, 129, 7, 128),       # one row past a 128-row box
])
def test_geometry_of_the_model_layout(b, s, h, d):
    """[B, S, H, D] read as its [B, H, S, D] view: a row of S steps over
    all H heads (H D elements), a head over D, a batch over S H D."""
    t = torch.zeros((b, s, h, d), dtype=BF16).transpose(1, 2)
    dims, strides, box = fa.tma_map_geometry(t)
    assert dims == (d, s, h, b)
    assert strides == (2 * h * d, 2 * d, 2 * s * h * d)
    assert box == BOX


@pytest.mark.parametrize("b,h,s,d", [
    (1, 32, 1024, 64),      # granite's served bucket
    (1, 56, 1024, 128),     # arctic's
    (3, 2, 127, 64),        # one row short of a box
])
def test_geometry_of_the_kernel_layout(b, h, s, d):
    """Contiguous [B, H, S, D]: a row steps over D, a head over S D, a
    batch over H S D."""
    t = torch.zeros((b, h, s, d), dtype=BF16)
    dims, strides, box = fa.tma_map_geometry(t)
    assert dims == (d, s, h, b)
    assert strides == (2 * d, 2 * s * d, 2 * h * s * d)
    assert box == BOX


def test_geometry_of_rows_padded_past_d():
    """Rows of 72 bf16 (144 bytes, a multiple of 16) with D 64 read in
    place: the map steps by the row's full width."""
    t = torch.zeros((2, 3, 200, 72), dtype=BF16)[..., :64]
    dims, strides, _ = fa.tma_map_geometry(t)
    assert dims == (64, 200, 3, 2)
    assert strides == (144, 144 * 200, 144 * 200 * 3)


@pytest.mark.parametrize("layout", ["model", "kernel"])
def test_a_dim_of_size_one_takes_the_extent_inside_it(layout):
    """One KV head (granite's 16 x 16 share) or one sequence: the dim is
    never stepped, so it takes the extent of the dims inside it as its
    stride, whatever stride torch gave it."""
    s, d = 256, 128
    t = torch.zeros((1, s, 1, d), dtype=BF16).transpose(1, 2) \
        if layout == "model" else torch.zeros((1, 1, s, d), dtype=BF16)
    dims, strides, _ = fa.tma_map_geometry(t)
    assert dims == (d, s, 1, 1)
    assert strides == (2 * d, 2 * d * s, 2 * d * s)


@pytest.mark.parametrize("make", [
    # rows of 68 bf16: 136 bytes, not a multiple of 16
    lambda: torch.zeros((1, 2, 128, 68), dtype=BF16)[..., :64],
    # heads 68 bf16 apart in the model layout
    lambda: torch.zeros((1, 128, 2, 68), dtype=BF16)[..., :64].transpose(
        1, 2),
    # batches 8 bytes apart
    lambda: torch.zeros((2 * 64 * 128 * 2 + 4,), dtype=BF16)[:2 * 64 * 128
                                                              * 2].view(
        2, 2, 128, 64).as_strided((2, 2, 128, 64), (4, 128 * 64, 64, 1)),
    # a repeated head (stride 0) over two heads
    lambda: torch.zeros((1, 1, 128, 64), dtype=BF16).expand(1, 2, 128, 64),
    # D 96: not whole 64-column panels
    lambda: torch.zeros((1, 2, 128, 96), dtype=BF16),
    # an empty sequence
    lambda: torch.zeros((1, 2, 0, 64), dtype=BF16),
    # a non-contiguous last dim
    lambda: torch.zeros((1, 2, 64, 128), dtype=BF16).transpose(2, 3),
])
def test_geometry_raises_on_what_a_map_cannot_express(make):
    with pytest.raises(ValueError, match="TMA map"):
        fa.tma_map_geometry(make())


def test_maps_argument_is_the_three_geometries():
    """The C entry point's `maps`, from the wrapper's dims and strides:
    q's, k's and v's 11 values of tma_map_geometry in turn."""
    q = torch.zeros((2, 300, 8, 64), dtype=BF16).transpose(1, 2)
    k = torch.zeros((2, 300, 2, 64), dtype=BF16).transpose(1, 2)
    geoms = tuple(fa.tma_map_geometry(t) for t in (q, k, k))
    arg = fa._maps_arg((2, 8, 2, 300, 300, 64),
                       (*q.stride()[:3], *k.stride()[:3], *k.stride()[:3],
                        *q.stride()[:3]))
    want = []
    for g in geoms:
        for part in g:
            want.extend(part)
    assert len(arg) == 33 and list(arg) == want
    assert want[:11] == [64, 300, 8, 2, 1024, 128, 300 * 8 * 64 * 2,
                         *BOX]


def _body(src: str, signature: str) -> str:
    start = src.index(signature)
    return src[start:src.index("\n}\n", start)]


def test_bf16_kernel_table_is_the_sources_dispatch():
    """BF16_KERNELS and CORE_KERNEL are what csrc/flash_attention.cu
    launches: bf16 at D 64 and 128 the warp-specialised kernel (with the
    maps of TMA_HEAD_DIMS), at D 256 the cp.async wgmma kernel, fp32 the
    CUDA-core kernel at every head dim; the boxes' rows are the kernel's
    query and key tiles."""
    src = (Path(fa.__file__).parent / "csrc"
           / "flash_attention.cu").read_text()
    bf16 = _body(src, "int launch_bf16(")
    cases = dict(re.findall(r"case (\d+): return (launch_\w+)", bf16))
    assert {int(d) for d in cases} == set(fa.BF16_KERNELS), cases
    for d, fn in cases.items():
        body = _body(src, f"int {fn}(")
        if fn == "launch_wgmma_256":      # picks the warpgroups a block
            body = _body(src, "int launch_wgmma(")
        launched = set(re.findall(r"(flash_attention_\w*kernel)<", body))
        assert launched == {fa.BF16_KERNELS[int(d)]}, (d, fn, launched)
    assert {d for d, k in fa.BF16_KERNELS.items()
            if k == "flash_attention_ws_kernel"} == set(fa.TMA_HEAD_DIMS)
    core = _body(src, "int launch(const FlashArgs& a, int batch")
    assert set(re.findall(r"(flash_attention_\w*kernel)<", core)) == {
        fa.CORE_KERNEL}
    for name in ("kWsRows", "kWsKeys"):
        assert re.search(rf"constexpr int {name} = (\d+);",
                         src).group(1) == str(fa.TMA_BOX_ROWS), name
