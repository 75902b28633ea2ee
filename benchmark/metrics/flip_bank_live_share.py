"""100 x the flip bank's rows that are not an identity pad after row 0
(the bank ICP runs that do distinct work) / all its rows, over the
profiled batches: the program's counters flip.live_bank_rows and
flip.bank_rows (nothing to read in a program without them)."""
from benchmark.program_counters import counter_share


def read(run):
    return counter_share(run, "flip.live_bank_rows", "flip.bank_rows")
