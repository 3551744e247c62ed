"""Wyoming protocol server for Home Assistant (reference: src/wyoming/)."""
