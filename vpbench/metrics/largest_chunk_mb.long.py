"""The window's largest chunk: the most dense spectrum bytes any call
merged into one program (stats["chunk_bytes_max"]), in MB (1e6 bytes);
None where the program does not count it."""


def read(run):
    sizes = []
    for c in run.calls:
        stats = c.stats or {}
        if "chunk_bytes_max" not in stats:
            return None
        sizes.append(stats["chunk_bytes_max"])
    return max(sizes) / 1e6 if sizes else None
