"""% of the traced training steps in which the card ran nothing (moves samples_per_s)."""

from readers import idle_share


def read(rec):
    return idle_share(rec)
