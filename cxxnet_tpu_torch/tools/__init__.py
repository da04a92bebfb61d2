"""Tools of the port, not imported by the package: measurement tools
that run on a card, and ``make_digits_idx`` (the digits fixture's idx
files)."""
