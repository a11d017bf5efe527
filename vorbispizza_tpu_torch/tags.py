"""Vorbis comment (tag) data.

Behavior parity with reference NVorbis/TagData.cs:8: KEY=value parsing
including the ``KEY[lang]=value`` form, multi-value map, named accessors.
"""

from __future__ import annotations


class TagData:
    def __init__(self, vendor: str = "", comments: list[str] | None = None):
        self.encoder_vendor = vendor
        self._tags: dict[str, list[str]] = {}
        for c in comments or []:
            if "=" not in c:
                continue
            key, value = c.split("=", 1)
            # strip [lang] qualifier (reference TagData.cs:28-37)
            if "[" in key and key.endswith("]"):
                base = key[: key.index("[")]
            else:
                base = key
            self._tags.setdefault(base.upper(), []).append(value)

    @property
    def all(self) -> dict[str, list[str]]:
        return self._tags

    def get_tag_single(self, key: str, concatenate: bool = False) -> str:
        vals = self._tags.get(key.upper(), [])
        if not vals:
            return ""
        return "\n".join(vals) if concatenate else vals[-1]

    def get_tag_multi(self, key: str) -> list[str]:
        return list(self._tags.get(key.upper(), []))

    # named accessors (reference ITagData surface)
    @property
    def title(self) -> str:
        return self.get_tag_single("TITLE")

    @property
    def artist(self) -> str:
        return self.get_tag_single("ARTIST")

    @property
    def album(self) -> str:
        return self.get_tag_single("ALBUM")

    @property
    def album_artist(self) -> str:
        return self.get_tag_single("ALBUMARTIST")

    @property
    def genre(self) -> str:
        return self.get_tag_single("GENRE")

    @property
    def track_number(self) -> str:
        return self.get_tag_single("TRACKNUMBER")

    @property
    def year(self) -> str:
        return self.get_tag_single("DATE") or self.get_tag_single("YEAR")

    @property
    def comment(self) -> str:
        return self.get_tag_single("COMMENT") or self.get_tag_single("DESCRIPTION")
