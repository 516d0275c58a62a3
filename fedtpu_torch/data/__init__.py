"""Datasets, partitions, augmentation and the device-resident layout."""
