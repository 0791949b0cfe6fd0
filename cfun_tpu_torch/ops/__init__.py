"""Geometry ops of the port: boxes, anchors, NMS, 3D sampling."""
