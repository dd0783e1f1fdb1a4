"""IO subsystem: the FFmpeg command builder and readers, the video sinks,
the frame pump behind FFmpegSink's turbo (C++, built with g++ at first
use), the display pump, the SDL window and the X11 key poller."""
