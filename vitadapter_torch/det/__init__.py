"""Detection: boxes, anchors, assignment, RoIAlign, necks, heads and the
detectors."""
