"""Inputs shared by the CPU tests of K2's pruned route
(test_torch_group_prune.py) and its card tests (test_torch_kernels_cuda.py);
numpy only, so the card's test run, which has no JAX, imports it too."""
import numpy as np


def on_grid(a):
    """f32 coordinates on a 2**-5 m grid: with |x|, |y| <= 75 m and
    |z| <= 4 m every product and partial sum of q.x is exact in f32."""
    return (np.round(a * 32.0) / 32.0).astype(np.float32)


ADV_R2 = 1305 * 2.0 ** -13                # 652.5 * 2**-12 m^2, exact in f32
ADV_R = float(np.sqrt(ADV_R2))


def adversarial():
    """Queries at |x|, |y| of 48-61 m (|q| 68-87 m) on a 2**-6 m grid in
    the plane z = 0, each with a Morton tile of its own: 256 copies of one
    source at a true squared distance of 650 to 661 * 2**-12 m^2, beside
    ADV_R2 = 652.5 * 2**-12. The products q_i x_i are exact in f32, but q.x,
    |q|^2, |x|^2 (~7000) and their sum (~14000) each round once, so the
    computed d2 lands a few 2**-12 on either side of the true one, on a
    2**-10 grid: sources truly outside r (653 * 2**-12) test as hits. Each
    tile's box is one point, so its gap^2 is the true distance, and without
    the margin the rule would skip tiles that hold hits. Exact products and
    z = 0 leave one rounding per sum in any summation order, so the JAX
    reference (a matmul cross term) computes the same d2 bits. Returns
    (xyz (1, 32 * 256, 3), valid, queries (1, 32, 3)); source rows
    256 g .. 256 g + 255 belong to query g."""
    rng = np.random.RandomState(7)
    G = 32
    slots = np.array([(sx * (48 + 3 * i) + 0.5, sy * (48 + 3 * j) + 0.5)
                      for sx in (-1, 1) for sy in (-1, 1) for i in range(5) for j in range(5)])
    xy = slots[rng.choice(len(slots), G, replace=False)] + rng.randint(0, 32, (G, 2)) / 64.0
    # (i, j) with i^2 + j^2 = 650, 653, 656, 657, 661
    off = np.array([(25, 5), (22, 13), (20, 16), (24, 9), (25, 6)])[np.arange(G) % 5]
    off = np.where(rng.rand(G, 1) < 0.5, off, off[:, ::-1]) * rng.choice([-1, 1], (G, 2))
    q = np.concatenate([xy, np.zeros((G, 1))], -1)
    src = q + np.concatenate([off / 64.0, np.zeros((G, 1))], -1)
    xyz = np.repeat(src, 256, axis=0)[None].astype(np.float32)    # (1, G * 256, 3)
    return xyz, np.ones(xyz.shape[:2], bool), q[None].astype(np.float32)
