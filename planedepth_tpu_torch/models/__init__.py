"""Networks of the inference slice: ResNet encoder, DenseASPP, plane DepthDecoder."""
