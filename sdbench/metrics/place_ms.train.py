"""Host ms a micro step spends placing its batch and draws on the card: the trainer's own
PhaseTimer "place" phase (SD_TRAIN_PROFILE), p50 over the window (moves samples_per_s)."""


def read(rec):
    return rec.get("place_ms_p50")
