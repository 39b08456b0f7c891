"""Networks of the port: the ResNet encoder with DenseASPP and the plane
DepthDecoder, PladeNet, FalNet, the pose networks (ResNet pose encoder +
PoseDecoder, PladePoseNet), the VGG19 / ResNet-18 perceptual nets, and the
API-parity Monov2Decoder and DepthDecoderContinuous."""
