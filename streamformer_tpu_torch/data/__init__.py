"""Host and on-device data handling of the port: the transforms and video
decoding its streaming consumers use."""
