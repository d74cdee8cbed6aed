"""The seeded traffic recipe: every seed gets the same work, in another
order and with other values; large seeds work."""

from collections import Counter

from chain_mix import draw

MIX = {"churn": 8, "transfer": 1, "call": 1}


def test_same_seed_same_draw_and_large_seeds():
    big = 2**31 + 12345
    assert draw(big, 2, 10, MIX, 2) == draw(big, 2, 10, MIX, 2)
    assert draw(big, 2, 10, MIX, 2) != draw(big + 1, 2, 10, MIX, 2)
    assert draw(2**63 + 7, 1, 10, MIX, 2)["keys"]


def test_every_seed_gets_the_same_kinds_and_paths():
    for seed in (1, 99, 2**40 + 3):
        d = draw(seed, 8, 100, MIX, 20)
        for kinds in d["kinds"]:
            assert Counter(kinds) == Counter({"churn": 80, "transfer": 10, "call": 10})
        # non-zero originals: every SSTORE takes the same gas branch
        assert all(0 < v < 2**32 for slots in d["storage"] for v in slots.values())
        assert len(set(d["keys"])) == 8
    orders = {tuple(draw(seed, 1, 10, MIX, 2)["kinds"][0]) for seed in range(20)}
    assert len(orders) > 1
