"""The pairwise-distance kernels' (kernels 1 and 4) contract on the CPU.

The CUDA kernel computes only the upper triangle of output tiles in self
mode and mirrors it, and picks its tile by shape; both are sound only
because (i) the plain self-distance versions are bitwise symmetric, (ii)
every output is the same walk over d (a rounded product, then a rounded
add, k in order, then the rounded epilogue) whatever the tile, and (iii)
the triangle's tiles and their mirrors cover each output once.  These
tests hold (i) and (ii) against ``kernels/ref.py`` and a numpy float32
emulation of one output's walk, and (iii) and the tile chooser's grid
against the shapes the main paths and ``chip_smoke.py``'s phase 2 use.
The kernel itself is held against the plain versions on the card
(``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.data import mnist_like_dataset
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

# the JAX kernel tests' shapes and ragged ones around the tiles' 16, 32
# and 64 rows
SELF_SHAPES = [(37, 60), (21, 200), (64, 128), (1, 32), (15, 129),
               (17, 60), (63, 33), (65, 32), (129, 16)]
BATCHED_SHAPES = [(2, 40, 129), (3, 37, 60), (1, 64, 16), (4, 8, 3),
                  (2, 17, 33), (3, 65, 20)]


def _x(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape)
                           .astype(np.float32))


@pytest.mark.parametrize("m,d", SELF_SHAPES)
def test_plain_self_distances_are_bitwise_symmetric(m, d):
    x = _x((m, d), m * 1000 + d)
    for squared in (True, False):
        out = ref.pairwise_l2_ref(x, squared=squared)
        assert torch.equal(out, out.T)
        z = ops.pairwise_l2(x, squared=squared, zero_diag=True)
        assert torch.equal(z, z.T)
        assert bool((torch.diagonal(z) == 0).all())


@pytest.mark.parametrize("c,m,d", BATCHED_SHAPES)
def test_plain_batched_self_distances_are_bitwise_symmetric(c, m, d):
    x = _x((c, m, d), c * 100 + m + d)
    for squared in (True, False):
        out = ref.pairwise_l2_batched_ref(x, squared=squared)
        assert torch.equal(out, out.transpose(1, 2))
        for i in range(c):      # each client's matrix is its own
            assert torch.equal(out[i], ref.pairwise_l2_ref(
                x[i], squared=squared))


def _walk(x, y, xsq, ysq, squared):
    """One output at a time, in numpy float32 scalars: acc += x·y as a
    rounded product then a rounded add, k in order; then
    max((xsq + ysq) − 2·acc, 0), and its square root unless squared."""
    f32 = np.float32
    out = np.empty((x.shape[0], y.shape[0]), dtype=np.float32)
    for r in range(x.shape[0]):
        for c in range(y.shape[0]):
            acc = f32(0.0)
            for k in range(x.shape[1]):
                acc = f32(acc + f32(x[r, k] * y[c, k]))
            v = f32(f32(xsq[r] + ysq[c]) - f32(f32(2.0) * acc))
            v = max(v, f32(0.0))
            out[r, c] = v if squared else np.sqrt(v)
    return out


@pytest.mark.parametrize("m,n,d", [(7, 7, 13), (5, 9, 40), (12, 12, 33)])
def test_emulated_walk_equals_plain_version(m, n, d):
    """The kernel's arithmetic, one output at a time, against the plain
    version bit for bit; the squared norms are the wrapper's
    ``torch.sum``, as the kernel is given them."""
    x = _x((m, d), m + d)
    y = x if m == n else _x((n, d), n * d)
    xsq = torch.sum(x * x, dim=-1).numpy()
    ysq = torch.sum(y * y, dim=-1).numpy()
    for squared in (True, False):
        want = ref.pairwise_l2_ref(x, None if m == n else y,
                                   squared=squared).numpy()
        got = _walk(x.numpy(), y.numpy(), xsq, ysq, squared)
        np.testing.assert_array_equal(got, want)


def _main_path_shapes():
    """(C, M) of every self-mode call phase 2 and the main paths make:
    kernel 1 at phase 2's m and at every sync client's size, kernel 4 at
    phase 2's stacks and the fleets' groups below the cutover."""
    sizes = sorted({len(d["y"]) for d in mnist_like_dataset(200, seed=0)})
    return ([(1, m) for m in (37, 39, 341, 1000, 2048)]
            + [(1, m) for m in sizes]
            + [(16, 128), (3, 37), (25, 128), (8, 16), (2, 32), (6, 32),
               (4, 64), (5, 64), (1, 128), (11, 128), (7, 128)])


H100_SMS = 132          # streaming multiprocessors of an H100 SXM


def test_chooser_fills_a_wave_or_takes_every_tile():
    """At every main-path shape the chosen tile gives an H100 at least one
    block an SM, or, where no configuration can, the most blocks any
    gives."""
    for c, m in _main_path_shapes():
        tile = ops.pairwise_tile(c, m, m, True, H100_SMS)
        grids = [ops.pairwise_grid(c, m, m, t, True)
                 for t in range(len(ops.PAIRWISE_TILES))]
        assert grids[tile] >= H100_SMS or grids[tile] == max(grids), \
            (c, m, ops.PAIRWISE_TILES[tile], grids)


@pytest.mark.parametrize("tile", range(len(ops.PAIRWISE_TILES)))
def test_grid_is_the_triangle_and_covers_each_output_once(tile):
    """In self mode the grid has one block per tile with tile-col >=
    tile-row; each writes its block, and an off-diagonal one also its
    mirror image, so every output is written exactly once.  With y given
    the grid is the full rectangle."""
    bm = ops.PAIRWISE_TILES[tile][0]
    for c, m in [(1, 1), (1, bm), (1, bm + 1), (3, 2 * bm - 1),
                 (2, 5 * bm + 3)]:
        nt = -(-m // bm)
        pairs = [(i, j) for i in range(nt) for j in range(nt) if j >= i]
        assert ops.pairwise_grid(c, m, m, tile, True) == c * len(pairs)
        writes = np.zeros((m, m), dtype=np.int64)
        for i, j in pairs:
            writes[i * bm:(i + 1) * bm, j * bm:(j + 1) * bm] += 1
            if i != j:
                writes[j * bm:(j + 1) * bm, i * bm:(i + 1) * bm] += 1
        assert (writes == 1).all()
        n = m // 2 + 1
        assert ops.pairwise_grid(c, m, n, tile, False) == \
            c * nt * -(-n // bm)


def test_forced_tile_is_checked_before_any_launch():
    """The private launchers the card tests force tiles through refuse a
    tile the kernel does not have, and a tensor off the card, before they
    build or launch anything; the public wrappers take no tile and run
    their plain versions on the CPU."""
    x = _x((3, 20, 17), 7)
    for tile in (-1, len(ops.PAIRWISE_TILES)):
        with pytest.raises(ValueError, match="PAIRWISE_TILES"):
            ops._pairwise_l2_batched_launch(x, False, True, tile)
        with pytest.raises(ValueError, match="PAIRWISE_TILES"):
            ops._pairwise_l2_launch(x[0], None, True, True, tile)
    for tile in (None, 0):
        with pytest.raises(ValueError, match="CUDA"):
            ops._pairwise_l2_batched_launch(x, False, True, tile)
        with pytest.raises(ValueError, match="CUDA"):
            ops._pairwise_l2_launch(x[0], x[1], True, False, tile)
    assert torch.equal(ops.pairwise_l2_batched(x, zero_diag=True),
                       ops.zero_self_diag(ref.pairwise_l2_batched_ref(x)))
    with pytest.raises(TypeError):
        ops.pairwise_l2(x[0], tile=0)


@pytest.mark.parametrize("c,m,tile", [
    (1, 2048, (32, 4)), (1, 1000, (32, 4)), (50, 128, (32, 4)),
    (1, 341, (16, 2)), (16, 128, (16, 2)), (25, 128, (16, 2)),
    (1, 39, (16, 2)), (1, 200, (16, 2)), (8, 16, (16, 2))])
def test_chooser_picks_by_blocks_an_sm(c, m, tile):
    """On an H100, 32-row tiles where they give every SM two blocks, else
    16-row tiles with 2 x 2 register blocks
    (``tools/pairwise_tiles.py --tiles`` times both at these shapes)."""
    assert ops.PAIRWISE_TILES[ops.pairwise_tile(c, m, m, True,
                                                H100_SMS)] == tile
