"""Decode tokens over the slot-steps dispatched [%], offline cells."""

from benchmark import readers


def read(run):
    return readers.slot_occupancy(run)
