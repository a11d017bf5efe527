"""Share of the window's streams whose plan and gather ran in the C++
front end (stats["front_native"] over stats["streams"]), in percent; None
where the program does not count them."""


def read(run):
    native = streams = 0
    for c in run.calls:
        stats = c.stats or {}
        if "front_native" not in stats:
            return None
        native += stats["front_native"]
        streams += stats.get("streams", 0)
    return 100.0 * native / streams if streams else None
