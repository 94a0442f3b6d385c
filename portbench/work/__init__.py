"""Work counts from shapes: FLOPs a clip and the kernels' bytes and
operations, which the shares of a peak or of a roofline divide by."""
