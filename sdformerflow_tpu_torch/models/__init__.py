"""The SDformerFlow model stack (PSN / BN eval subset)."""
