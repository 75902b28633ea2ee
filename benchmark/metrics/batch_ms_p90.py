"""90th percentile of every batch's wall in the window (host clock),
ms."""
import statistics


def read(run):
    if len(run.walls_s) < 10:
        return None
    return 1e3 * statistics.quantiles(run.walls_s, n=10,
                                      method="inclusive")[-1]
