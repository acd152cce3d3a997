"""% of the traced txt2img calls in which the card ran nothing (moves images_per_s)."""

from readers import idle_share


def read(rec):
    return idle_share(rec)
