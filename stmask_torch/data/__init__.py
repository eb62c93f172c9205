"""Frame decoding, the YouTube-VIS annotation accessors, frame and batch
preparation on the device, and a synthetic YouTube-VIS writer."""
