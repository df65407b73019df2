"""Misspelling generator behaviour tests."""

import random

from doppelspeller.utils.misspell import (
    EUCLIDEAN_NEIGHBOURS,
    add_letter,
    add_space,
    generate_misspelled_name,
    remove_letter,
    remove_space,
    replace_letter,
    swap_word,
)


def test_neighbours_are_adjacent():
    assert "s" in EUCLIDEAN_NEIGHBOURS["a"]
    assert "q" in EUCLIDEAN_NEIGHBOURS["a"]
    assert "p" not in EUCLIDEAN_NEIGHBOURS["a"]
    # every key letter has at least one neighbour
    for k, v in EUCLIDEAN_NEIGHBOURS.items():
        assert len(v) >= 1


def test_ops_preserve_alphabet():
    rng = random.Random(0)
    title = "coolblue holdings 42"
    for op in (remove_letter, add_letter, replace_letter, add_space, remove_space, swap_word):
        for _ in range(20):
            out = op(title, rng)
            assert set(out) <= set("abcdefghijklmnopqrstuvwxyz0123456789 ")


def test_remove_letter_never_removes_space():
    rng = random.Random(1)
    for _ in range(50):
        out = remove_letter("ab cd", rng)
        assert out.count(" ") == 1


def test_protected_chars_not_mutated():
    rng = random.Random(2)
    # all-digit title: add/replace must give up and return unchanged
    assert add_letter("1234 567", rng) == "1234 567"
    assert replace_letter("1234 567", rng) == "1234 567"


def test_generate_misspelled_name_differs_mostly():
    rng = random.Random(3)
    title = "international house newcastle"
    changed = sum(generate_misspelled_name(title, rng) != title for _ in range(50))
    assert changed >= 40  # most mutations actually change the title


def test_generate_is_normalized():
    rng = random.Random(4)
    for _ in range(20):
        out = generate_misspelled_name("coolblue holdings bv", rng)
        assert out == out.strip()
        assert "  " not in out
