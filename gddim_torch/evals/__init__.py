"""FID, IS and KID, the proxy extractor and InceptionV3."""
