"""Tables the calls built again (stats["builds"]: setup parses,
synthesizers, wire layouts, K1 descriptor tables and bucket tables, each
counted at its cache's miss), the mean over the window's calls."""


def read(run):
    counts = []
    for c in run.calls:
        builds = (c.stats or {}).get("builds")
        if builds is None:
            return None
        counts.append(sum(builds.values()))
    return sum(counts) / len(counts) if counts else None
