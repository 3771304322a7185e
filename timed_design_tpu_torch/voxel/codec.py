"""Atom-channel codecs for voxel frames.

The same codec as ``timed_design_tpu/voxel/codec.py``, kept here because that
package's ``voxel`` imports JAX on import. Framework-native replacement for aposteriori's `Codec` (reference ui.py:79
``Codec.CNOCACB()``, README.md:91 codec strings CNOCBCA / CNOCBCAQ / CNOCBCAP).
A codec names the channels of the frame tensor: element channels (C, N, O),
optional dedicated CA / CB channels, and optional property channels
(P = Zimmerman polarity class, Q = coarse charge) used by the
property-constrained design flow.
"""
from __future__ import annotations

import dataclasses
import re

_TOKEN_RE = re.compile(r"CA|CB|[CNOSPQ]")


@dataclasses.dataclass(frozen=True)
class Codec:
    """Ordered channel list, e.g. ('C','N','O','CB','CA') for CNOCBCA."""

    channels: tuple[str, ...]

    @staticmethod
    def from_string(spec: str) -> "Codec":
        """Parse a codec string by greedy left-to-right tokenization.

        ``CNOCBCA`` -> C, N, O, CB, CA;  ``CNOCACBQ`` -> C, N, O, CA, CB, Q.
        """
        tokens = _TOKEN_RE.findall(spec.upper())
        if "".join(tokens) != spec.upper():
            raise ValueError(f"Cannot parse codec string {spec!r}")
        return Codec(tuple(tokens))

    # Preset constructors mirroring aposteriori's Codec classmethods.
    @staticmethod
    def CNO() -> "Codec":
        return Codec(("C", "N", "O"))

    @staticmethod
    def CNOCB() -> "Codec":
        return Codec(("C", "N", "O", "CB"))

    @staticmethod
    def CNOCACB() -> "Codec":
        return Codec(("C", "N", "O", "CA", "CB"))

    @staticmethod
    def CNOCBCA() -> "Codec":
        return Codec(("C", "N", "O", "CB", "CA"))

    @staticmethod
    def CNOCACBQ() -> "Codec":
        return Codec(("C", "N", "O", "CA", "CB", "Q"))

    @staticmethod
    def CNOCACBP() -> "Codec":
        return Codec(("C", "N", "O", "CA", "CB", "P"))

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    @property
    def name(self) -> str:
        return "".join(self.channels)

    @property
    def property_channel(self) -> str | None:
        """'P', 'Q' or None — at most one property channel is supported."""
        props = [c for c in self.channels if c in ("P", "Q")]
        if len(props) > 1:
            raise ValueError(f"Codec {self.name} has multiple property channels")
        return props[0] if props else None

    def atom_channel(self, atom_name: str, element: str) -> int:
        """Channel index for an atom, or -1 if the codec drops it.

        Dedicated CA/CB channels win over the element channel; all other
        backbone atoms land on their element channel.
        """
        if atom_name == "CA" and "CA" in self.channels:
            return self.channels.index("CA")
        if atom_name == "CB" and "CB" in self.channels:
            return self.channels.index("CB")
        # P/Q are PROPERTY channels (polarity/charge), never element
        # channels: a phosphorus atom (element 'P', e.g. from a remapped
        # SEP/TPO under atom_filter='all') must not scatter raw density
        # into the polarity channel
        if element in self.channels and element not in ("P", "Q"):
            return self.channels.index(element)
        return -1

    def __str__(self) -> str:  # pragma: no cover
        return f"Codec({self.name})"
