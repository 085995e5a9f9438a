"""The ARAP deformation model."""
