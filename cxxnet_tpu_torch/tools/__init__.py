"""Measurement tools of the port that run on a card (not imported by the
package)."""
