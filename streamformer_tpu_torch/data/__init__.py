"""Host and on-device data handling of the port: datasets, samplers, video
decoding, the augmentations on the device and the multitask loader."""
