"""Mean ms a request spends in call's anchor rounds (run-stat timer
`call_anchors`, summed over its contigs)."""


def read(run):
    if not run.requests or "call_anchors_s" not in run.stats:
        return None
    return 1e3 * run.stats["call_anchors_s"] / len(run.requests)
