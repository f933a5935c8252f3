"""The seeded scene generator: the same seed gives the same bits."""

import torch

from benchmark.harness import scenes

CPU = torch.device("cpu")


def test_same_seed_same_bits_different_seeds_differ():
    big = 2 ** 40 + 3          # seeds beyond 32 bits
    a = scenes.scenes(3, (72, 100), 30, big, CPU)
    b = scenes.scenes(3, (72, 100), 30, big, CPU)
    c = scenes.scenes(3, (72, 100), 30, big + 1, CPU)
    assert a.dtype == torch.uint8 and a.shape == (3, 72, 100)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])          # a pool of distinct scenes
    assert int(a.min()) == 0 and int(a.max()) >= 250


def test_blobs_are_where_the_recipe_puts_them():
    # one blob on a flat background lies at 10-90 % of each axis
    img = scenes.scenes(1, (200, 300), 1, 5, CPU)[0].float()
    dev = (img - img.median()).abs()
    r, c = divmod(int(dev.argmax()), 300)
    assert 0.05 * 200 <= r <= 0.95 * 200 and 0.05 * 300 <= c <= 0.95 * 300
