"""Developer tools of the port that run on the card (not imported by the
package)."""
