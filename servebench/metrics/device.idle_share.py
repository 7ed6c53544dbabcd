"""device.idle_share (%): 1 - the union of a card's operation intervals
over the profiled slice's wall time; over several cards, the mean of that
over the cards (each card's own idle time, not the union of all cards')."""


def read(run):
    sl = run.slice
    if sl is None or sl.wall_s <= 0:
        return None
    cards = sl.card_ids()
    return 100.0 * sum(1.0 - sl.busy_s(c) / sl.wall_s for c in cards) / len(cards)
