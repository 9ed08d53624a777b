// Buffers the feed hands to Python (pt_feed_next) are malloc'd; Python frees
// each one through pt_buffer_free once it has copied the bytes out.
#include <cstdlib>

extern "C" {

void pt_buffer_free(void* p) { std::free(p); }

}  // extern "C"
