"""The serve tier's device-resident ring state."""
